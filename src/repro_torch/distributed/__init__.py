"""Multi-device support: the GPipe pipeline executor (``pipeline``, the
FINN dataflow's one compute unit a layer range, each stage on a CUDA
stream of its own) and the straggler detector that serving's replica
health needs.  The LM training distribution (sharding, fault tolerance)
waits for the LM stack: ROADMAP queue A item 7, step 3."""
