"""Set-up seconds: from the process's start (imports, inputs, builds,
warm-up of every shape the traffic uses) to the window's opening."""


def read(run, trace):
    return run.setup_s
