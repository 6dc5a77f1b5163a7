"""setup_s: process start to the window's start (host clock)."""


def read(record):
    return record["setup_s"]
