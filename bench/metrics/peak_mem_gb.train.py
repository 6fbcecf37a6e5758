"""peak_mem_gb.train: torch.cuda.max_memory_allocated over the window, in GB (1e9 bytes)."""


def read(rec):
    return rec.window["peak_bytes"] / 1e9 if "peak_bytes" in rec.window else None
