"""``chip_smoke.phase_autoscale`` rehearsed on the CPU (``dev="cpu"``):
the tiny model stands in for Llama-3-8B and the card's tools are not
reached (the card line is passed in).  Every gate of the phase but the
card's own (K1 and K4 launched, the card's memory given back, the 60-s
limit) holds: a head with no card, one create for the pending
``num_gpus=1`` task, the task on the added node with its grant in
``CUDA_VISIBLE_DEVICES``, its output bit-identical to ``_block`` here,
one delete of the same slice, and the instance's whole history."""

import torch


def test_chip_smoke_autoscale_phase_runs_on_cpu():
    import chip_smoke as cs
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = llama_init(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    report = {}
    cs.phase_autoscale(torch, report, cfg, params, 0, "cpu", dev="cpu")
    out = report["autoscale"]
    assert out["bit_identical"] and out["node"] in out["added_nodes"]
    assert out["visible"] == "0"
    assert not any(out["launches"].values())
    assert out["history"] == cs.AS_HISTORY
    assert out["create"]["machine_type"] == "a3-highgpu-1g"
    assert (out["create"]["count"], out["create"]["accelerator_count"]) \
        == (1, 1)
    assert out["scale_down_s"] >= cs.AS_IDLE_S
    for key in ("scale_up_s", "worker_start_s", "worker_import_s",
                "task_s", "submit_to_result_s"):
        assert out[key] > 0, key
