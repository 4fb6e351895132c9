"""Prefill's share of the card's bf16 peak (%): the model FLOP of the real
prompt tokens of every prefill that started in the traced window (2N a
token plus causal attention: the 6N + 6 L S d training convention in
forward form),
over the summed time of their ``engine:prefill`` spans."""


def read(run):
    ys = run.yardstick
    port = run.config["port"]
    flop = secs = 0.0
    for s in run.spans:
        if s["name"] == "engine:prefill" and run.t0 <= s["start"] < run.t1:
            n = s["attrs"]["prompt_len"] - s["attrs"].get("cached_prefix", 0)
            flop += ys.prefill_flop(port, n)
            secs += s["end"] - s["start"]
    if secs <= 0:
        return None
    return flop / secs / ys.PEAK_BF16_FLOPS * 100
