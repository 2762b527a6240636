"""certified_share.dense (%, program counter): the measured window's
queries that the dense tier's certificate proved, from
``VectorStore.tier_fallback_queries`` (queries re-run on fp32)."""


def read(ctx):
    c, q = ctx.counters, ctx.window.queries
    if "tier_fallback_queries" not in c["after"] or not q:
        return None
    return 100.0 * (1.0 - (c["after"]["tier_fallback_queries"] - c["before"]["tier_fallback_queries"]) / q)
