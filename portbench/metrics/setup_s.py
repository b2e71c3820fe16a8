"""Set-up seconds: from the process's start (imports, the card's context, inputs and weights made, the program built, every shape warmed up) to the window's start. Host clock."""


def read(run):
    return run.setup_s
