"""Seconds from the process's start to the window's: imports, the kernels'
build where none is cached, deploy (export, the AOTInductor packages from
the cache or compiled, the snapshot) and the warm-up invocations."""


def read(run):
    return run.setup_s
