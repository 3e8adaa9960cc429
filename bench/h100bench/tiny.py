"""The cells at a size the CPU holds, for the benchmark's CPU tests.

:func:`small` gives a cell's overrides for
:func:`h100bench.harness.run_cell`: the same model family, traffic kind
and output check at tiny widths, a few slots and short prompts.
"""

from h100bench.registry import Registry

TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 32, "num_hidden_layers": 2, "vocab_size": 256}


def small(cell: str) -> dict:
    """The cell at a size the CPU holds, with its own output check's
    limits (a tiny window serves fewer tokens than ``min_tokens``)."""
    if cell.startswith("qwen3-moe"):
        cfg = dict(TINY, num_experts=8, num_experts_per_tok=2,
                   moe_intermediate_size=32)
        mix = {"initial": 6, "rate_per_tick": 0.4,
               "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.8,
                          "min": 4, "max": 60},
               "output": {"dist": "lognormal", "median": 10, "sigma": 0.5,
                          "min": 3, "max": 30}}
        eng = {"max_batch": 8, "max_len": 96, "page": 16,
               "prefill_chunk": 16, "n_blocks": None}
        start = 4
    else:
        cfg = dict(TINY, intermediate_size=96)
        mix = {"rate_per_tick": 0.2,
               "document": {"dist": "loguniform", "min": 32, "max": 96},
               "question": {"dist": "loguniform", "min": 4, "max": 16},
               "answer": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                          "min": 3, "max": 16},
               "followup_ticks": {"dist": "uniform", "min": 3, "max": 8}}
        eng = {"max_batch": 4, "max_len": 144, "page": 16,
               "prefill_chunk": 32, "n_blocks": 64}
        start = 10
    check = dict(Registry().workload(cell)["check"], min_tokens=20)
    return {"config": cfg, "traffic": mix,
            "workload": {"engine": eng, "start_step": start,
                         "trace_seconds": 0.3, "check": check}}
