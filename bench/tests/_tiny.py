"""A copy of the benchmark with tiny cells of its own, for runs on the CPU.

`tiny_root(tmp)` copies `bench/` and writes a `BENCHMARK.json` whose
cells use new configuration, traffic and limits files only: a dense
decoder and a mixture of experts (on 4 slots and on 16) at sizes a test
holds.  The cells reuse the benchmark's readers and references.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "kv_heads": 2,
        "head_dim": 16, "d_ff": 128, "vocab": 256,
        "pattern": [["global", "mlp"]], "tie_embeddings": True,
        "rope_theta": 10000.0, "norm_eps": 1e-05, "quant_bits": 8,
        "dtype": "bfloat16"}
TINY_MOE = dict(TINY, pattern=[["local", "moe"]], window=8, n_experts=4,
                top_k=2, capacity_factor=1.25, moe_group=512,
                tie_embeddings=False)
MIX = {"loop": "closed", "slots": 4, "max_len": 24, "scale": 1.0,
       "prompt_len": {"dist": "lognormal", "median": 3, "mean": 3.5,
                      "min": 1, "max": 8},
       "output_len": {"dist": "lognormal", "median": 4, "mean": 5.5,
                      "min": 1, "max": 12},
       "size_seed": 7, "requests_per_s": 12.0}
MIX16 = dict(MIX, slots=16, requests_per_s=48.0)
CELLS = {"tiny-serve": ("tiny-dense", "tiny-mix", TINY, "dense_gqa", MIX),
         "tiny-moe": ("tiny-moe", "tiny-mix", TINY_MOE, "moe_decoder", MIX),
         "tiny-moe16": ("tiny-moe", "tiny-mix16", TINY_MOE, "moe_decoder",
                        MIX16)}
LIMITS = {"logit_gap": 0.05, "schedule_steps": 0, "failed": 0}
MOE_LIMITS = {"stage_err": 0.02, "token_mismatch": 0, "schedule_steps": 0,
              "failed": 0}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_root(tmp: Path, extra_per_layer=()) -> Path:
    """A checkout-like root holding `bench/` and the tiny cells."""
    root = Path(tmp)
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name, (config, mix, model, ref, traffic) in CELLS.items():
        if not any(c["name"] == config for c in bench["configs"]):
            _write(root / "bench" / "configs" / f"{config}.json",
                   {"source": "test", "arch": "smollm-360m"
                    if ref == "dense_gqa" else "mixtral-8x7b",
                    "reference": ref, "model": model, "reduced": []})
            bench["configs"].append({"name": config, "source": "test",
                                     "file": f"bench/configs/{config}.json",
                                     "reduced": [], "why": "test"})
        _write(root / "bench" / "traffic" / f"{mix}.json", traffic)
        spec_ = {"sample_tokens": 30, "limits": dict(LIMITS)}
        if ref == "moe_decoder":
            spec_ = {"follow": "stages", "limits": dict(MOE_LIMITS)}
        _write(root / "bench" / "limits" / f"{name}.json", spec_)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w["name"] for w in bench["workloads"]]
            if m["name"] == "moe_apply_roofline":
                m["workloads"] = ["tiny-moe", "tiny-moe16"]
            if m["name"] == "serve_request_p95_s":
                m["workloads"] = ["tiny-serve"]
    bench["per_layer"] += list(extra_per_layer)
    _write(root / "BENCHMARK.json", bench)
    return root
