"""``chip_smoke.phase_serve_front`` rehearsed on the CPU (``dev="cpu"``):
the tiny model stands in for b1 and for Llama-3-8B, and the card's tools
are not reached (the card line is passed in).  Every gate of the phase
holds: weight checksums, tokens through the handle and as SSE equal to
an in-process engine's in a cold and a warm pass, the adapter from the
object store, the pages after the cancels, and the engine's spans of
every request at the head; the csrc kernels launch none on the CPU."""

import torch


def test_chip_smoke_serve_front_phase_runs_on_cpu():
    import chip_smoke as cs

    report = {}
    cs.phase_serve_front(torch, report, 0, "cpu", dev="cpu")
    out = report["serve_front"]
    assert not any(out["launches"].values())
    b1, big = out["b1"], out["8b"]
    assert b1["model"] == big["model"] == "tiny"
    assert b1["tokens_equal"] and b1["store_adapter_equal"]
    assert b1["pages_balanced"] and b1["cancelled"] == 2
    assert big["tokens_equal"] and big["free_pages"] == big["total_pages"]
    for res in (b1, big):
        for name in ("cold", "warm"):
            t = res[name]
            assert len(t["requests"]) == 12
            assert t["tokens"] == (12 * 32 if res is big
                                   else 11 * 32 + cs._FRONT_CANCEL_AT)
            assert all(r["client_ttft_ms"] > 0 and r["engine_ttft_ms"] > 0
                       for r in t["requests"])
    assert {r["via"] for r in b1["cold"]["requests"]} == {"handle", "sse"}
