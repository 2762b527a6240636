"""dense_scan_roofline.dsv2 (%, device trace): K1 at 2,048-d, read as
``dense_scan_roofline`` is: the least time of the dense scan's work
(``benchmark/work/dense.py``) over the device-busy time inside the staged
pass's ``scan`` spans (the tier's kernel, selection, the exact rescore and
any fp32 fallback), summed over the staged batches."""

from benchmark.work import dense


def read(ctx):
    st = ctx.staged
    dev = (st or {}).get("device", {}).get("scan")
    if not ctx.on_device or not dev or sum(dev) <= 0 or "d" not in st["shapes"][0]:
        return None
    least = sum(dense.least_seconds(s)[0] for s in st["shapes"])
    return 100.0 * least / sum(dev)
