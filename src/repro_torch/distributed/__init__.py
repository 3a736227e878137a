"""Distributed pieces of the port (``repro_torch.distributed``): the po2
wire codec and cross-process mean, the engine's process grid, and the
checkpoint/restart runner."""

from repro_torch.distributed.fault_tolerance import (FailureInjector, RunnerConfig,
                                                     TrainingRunner, Watchdog,
                                                     elastic_reshard)
