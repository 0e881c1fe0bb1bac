"""The card's peak reserved memory (``torch.cuda.max_memory_reserved``,
graph pools included), read when the window has closed, in GiB."""


def read(record):
    return record["peak_mem_bytes"] / 2**30 if record["peak_mem_bytes"] else None
