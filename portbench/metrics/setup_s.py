"""From the start of the process to the first timed request: imports,
kernel builds, the inputs, and the warm request that builds the device
program."""


def read(run):
    return run.setup_s
