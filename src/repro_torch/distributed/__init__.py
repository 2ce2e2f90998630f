"""Multi-device support.  Only the straggler detector that serving's replica
health needs is here; the pipeline, sharding and fault-tolerance modules
are ROADMAP queue A item 6."""
