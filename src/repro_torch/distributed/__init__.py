"""Multi-device support: the GPipe pipeline executor (``pipeline``, the
FINN dataflow's one compute unit a layer range, each stage on a CUDA
stream of its own), the straggler detector that serving's replica health
and the training step watchdog share (``stragglers``), and training's
fault tolerance (``fault_tolerance``: the checkpoint manager and the step
watchdog).  The LM training's sharding waits for ROADMAP queue A item 7,
step 3c."""
