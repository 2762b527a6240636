"""device_us_per_query.dense (us, device trace): the card's busy time per
query answered in the dense cell: the device-busy microseconds of the
traffic's first ``device_batches`` batches, run as the window runs them
under the profiler after the window, over their queries. It holds every
operation the queries cost the card (the encoder, the tier's scan,
selection, rescore and any fp32 fallback), and no host time."""


def read(ctx):
    t = ctx.trace
    if not ctx.on_device or not t or t["busy_s"] <= 0 or not t.get("queries"):
        return None
    return 1e6 * t["busy_s"] / t["queries"]
