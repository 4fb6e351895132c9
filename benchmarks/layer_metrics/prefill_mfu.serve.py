"""Prefill's share of the card's bf16 peak (%): the model FLOP of the real
prompt tokens (the family's ``prefill_flop``: for the dense family 2N a
token plus causal attention, the 6N + 6 L S d training convention in
forward form) of every prefill whose ``engine:prefill`` span lies inside
the traced window, over the summed time of those spans.  A prefill cut
by the window's edges is left out: the profiler's stop at the window's
end stretches one still running."""


def read(run):
    ys = run.yardstick
    port = run.config["port"]
    flop = secs = 0.0
    for s in run.spans:
        if s["name"] == "engine:prefill" and run.t0 <= s["start"] \
                and s["end"] <= run.t1:
            n = s["attrs"]["prompt_len"] - s["attrs"].get("cached_prefix", 0)
            flop += run.family.prefill_flop(port, n)
            secs += s["end"] - s["start"]
    if secs <= 0:
        return None
    return flop / secs / ys.PEAK_BF16_FLOPS * 100
