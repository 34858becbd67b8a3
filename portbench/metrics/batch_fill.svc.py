"""Service layer: the batch lanes that carried a request, in %: the
service's counters ``batched_requests`` over ``batches`` × ``max_batch``.
Moves ``maps_per_s``."""


def read(ctx):
    stats = ctx.window.stats
    if not stats.get("batches"):
        return None
    lanes = stats["batches"] * ctx.config["service"]["max_batch"]
    return 100.0 * stats["batched_requests"] / lanes
