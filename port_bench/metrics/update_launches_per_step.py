"""Kernel launches of the plan's update a simulation step: the update
kernels' ``<wrapper>.launches`` counters (the dense, conv and counter
kernels, ``trace.KERNEL_MODULES``) over the traced stretch, divided by its
steps."""


def read(tr):
    if tr.traffic["mode"] != "train" or not tr.steps:
        return None
    return sum(tr.launches.values()) / tr.steps
