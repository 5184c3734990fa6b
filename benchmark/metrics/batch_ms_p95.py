"""batch_ms_p95 (end to end): the 95th percentile, over every batch that
completed in the window, of its latency in ms: the card's time (CUDA
events) from the completion that freed its slot in the closed loop, which
the entry call follows at once, to its own completion. The batches in
flight ahead of it are included; a stall on the host or the card moves
it. Under 20 batches there is no tail to read, and it reads nothing."""

import statistics


def read(rec):
    lat = rec["latencies_ms"]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
