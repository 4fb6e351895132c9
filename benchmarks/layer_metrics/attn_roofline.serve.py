"""Prefill attention's share of its roofline (%): for every prefill in the
traced window whose ``engine:prefill`` span holds exactly one attention
forward (a ``flash_fwd`` kernel) a layer, the least time of those calls
at their input shapes (each layer's heads, head size and window from the
configuration's family, ``attention_shapes``; the bucket the prompt was
padded to, one sequence, causal) over their device time.  Prefills cut by
the window's edges are left out, their kernels with them."""

import collections

KERNEL = "flash_fwd"


def read(run):
    ys = run.yardstick
    shapes = collections.Counter(run.family.attention_shapes(
        run.config["port"]))
    L = sum(shapes.values())
    calls = run.trace.named(run.ops, KERNEL)
    least = dev = 0.0
    for s in run.spans:
        if s["name"] != "engine:prefill" or not run.t0 <= s["start"] \
                or s["end"] > run.t1:
            continue
        inside = [c for c in calls if s["start"] <= c[1] and c[2] <= s["end"]]
        if len(inside) != L:
            continue
        bucket = s["attrs"]["bucket"]
        least += sum(n * ys.min_time(*ys.attention_fwd(
            1, H, Hkv, bucket, D, window=w))
            for (H, Hkv, D, w), n in shapes.items())
        dev += sum(e - b for _, b, e in inside)
    return least / dev * 100 if dev > 0 else None
