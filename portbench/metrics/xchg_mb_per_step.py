"""Megabytes (1e6 bytes) a step that the exchange moves between shards:
the counters of ``tpgsd_torch.parallel.exchange`` (``local_bytes``
between the shards of this process, ``bytes`` to other processes) over
the decomposed steps taken (``steps``), all since the harness reset
them after the warm-up.  ``None`` where the program keeps no such
counters or took no decomposed step."""


def read(rec):
    from tpgsd_torch.parallel import exchange

    stats = exchange.stats
    steps = stats.get("steps")
    n_bytes = stats.get("local_bytes", 0) + stats.get("bytes", 0)
    if not steps or not n_bytes:
        return None
    return n_bytes / steps / 1e6
