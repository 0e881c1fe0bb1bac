"""Seconds from the process's start to the first timed unit of work:
imports, building and loading, warm-up, graph captures, kernel builds."""


def read(record):
    return record["setup_s"]
