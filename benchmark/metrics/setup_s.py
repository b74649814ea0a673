"""From the process's spawn to the first frame of the measured window."""


def read(rec):
    return rec["setup_s"]
