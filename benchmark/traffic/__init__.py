"""Traffic drivers. A cell's mix file (``workloads/<cell>.json``) names its
driver (``train_step`` or ``index``) and the parameters it reads: the batch
schema and sizes, the pool of distinct batches, the log cadence and the
stretch the traced run profiles. ``batches.py`` makes every batch from the
seed."""
