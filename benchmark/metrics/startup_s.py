"""Mean seconds from spawning a job's process to its entry into
``fqtool_tpu_torch.main.main``: the interpreter, the imports and the CUDA
context (``child.py`` stamps it).  In-process jobs have none."""


def read(record):
    s = record["startup_s"]
    return sum(s) / len(s) if s else None
