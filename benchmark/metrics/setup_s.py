"""Seconds from the process's start to the window: imports, the session
made on the card, the program's set-up and one warm step."""


def read(run):
    return run["setup_s"]
