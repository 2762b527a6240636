"""certified_share.maxsim (%, program counter): the measured window's
queries that the tiered store's certificate proved, from
``TokenVectorStore.uncertified`` (queries re-run on the exact scan)."""


def read(ctx):
    c, q = ctx.counters, ctx.window.queries
    if "uncertified" not in c["after"] or not q:
        return None
    return 100.0 * (1.0 - (c["after"]["uncertified"] - c["before"]["uncertified"]) / q)
