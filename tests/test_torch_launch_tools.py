"""The port's launch tools (`launch.shapes`, `dryrun`, `roofline`,
`report`, `hillclimb`) against the JAX package's, on the CPU.

- `shapes.cells()` and every `input_specs` tensor (batch and decode
  states, leaf by leaf) have JAX's shapes and dtypes, for all 40 cells;
  the JAX package stacks a pattern period's decode states, the port keeps
  one dict a layer, so JAX's are unstacked to compare;
- param bytes and decode-state bytes equal JAX's `eval_shape` totals, and
  `roofline.model_flops` equals JAX's exactly, for the ten configs;
- in one subprocess, on fake (4, 2) meshes with a reduced SmolLM: the
  counted FLOPs of a prefill forward are a hand count of its products on
  one rank's shards, all-replicated rules move no collective byte while
  FSDP rules all-gather, argument bytes are the local shards' sum, and
  the four CLIs run on reduced cells into a temp results directory; on
  a fake (8, 1) mesh the all-gather `DTensor` issues inside a product
  is counted to the byte, and a token loop's count extrapolated from
  three lengths is its direct count;
- no module of the port carries a TPU figure.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest

from repro import configs as jconfigs
from repro.launch import report as jreport
from repro.launch import shapes as jshapes
from repro_torch import configs
from repro_torch.launch import report, roofline, shapes

ROOT = Path(__file__).resolve().parents[1]


def _jax_roofline():
    """`repro.launch.roofline`, whose import sets XLA_FLAGS for 512 host
    devices: the backend is started first, so the flag cannot take, and
    the variable is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import roofline as jroofline
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jroofline


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _jax_layer_states(cfg, tree):
    """JAX's decode states (stacked by pattern period) as one dict a
    layer, in the port's order: {name: (shape, dtype)}."""
    plen = len(cfg.pattern)
    n_groups, n_rem = divmod(cfg.n_layers, plen)
    out = [None] * cfg.n_layers
    if "groups" in tree:
        for i in range(plen):
            for g in range(n_groups):
                out[g * plen + i] = {
                    k: (tuple(v.shape[1:]), str(v.dtype))
                    for k, v in tree["groups"][f"l{i}"].items()}
    else:
        for g, grp in enumerate(tree.get("group_list", [])):
            for i in range(plen):
                out[g * plen + i] = {k: (tuple(v.shape), str(v.dtype))
                                     for k, v in grp[f"l{i}"].items()}
    for i, st in enumerate(tree["rem"]):
        out[n_groups * plen + i] = {k: (tuple(v.shape), str(v.dtype))
                                    for k, v in st.items()}
    return out


def test_cells_equal_jax():
    assert shapes.cells() == jshapes.cells()
    assert shapes.cells(True) == jshapes.cells(True)
    assert len(shapes.cells(True)) == 40
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in shapes.SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind)
        for k, v in jshapes.SHAPES.items()}
    assert shapes.SUB_QUADRATIC == jshapes.SUB_QUADRATIC


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in
                                        jshapes.cells(True)])
def test_input_specs_equal_jax(arch, shape):
    want = jshapes.input_specs(arch, shape)
    got = shapes.input_specs(arch, shape)
    assert got["kind"] == want["kind"]
    assert got["cfg"].name == want["cfg"].name
    wb, gb = want["batch"], got["batch"]
    assert set(gb) == set(wb)
    for k, v in wb.items():
        if k == "states":
            continue
        assert tuple(gb[k].shape) == tuple(v.shape), k
        assert _dtype(gb[k].dtype) == str(v.dtype), k
        assert gb[k].device.type == "meta"
    if "states" in wb:
        layers = _jax_layer_states(want["cfg"], wb["states"])
        assert len(gb["states"]) == len(layers)
        for j, (st, ref) in enumerate(zip(gb["states"], layers)):
            assert {k: (tuple(t.shape), _dtype(t.dtype))
                    for k, t in st.items()} == ref, j


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_and_state_bytes_equal_jax(arch):
    assert report._param_bytes(arch) == jreport._param_bytes(arch)
    assert report._state_bytes(arch, "decode_32k") == \
        jreport._state_bytes(arch, "decode_32k")


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_model_flops_equal_jax(arch):
    jroofline = _jax_roofline()
    for kind, tokens in (("train", 256 * 4096), ("prefill", 32 * 32768),
                         ("decode", 128)):
        assert roofline.model_flops(configs.get(arch), tokens, kind) == \
            jroofline.model_flops(jconfigs.get(arch), tokens, kind)


def test_h100_figures():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    assert (report.PEAK_FLOPS, report.HBM_BW) == (989e12, 3.35e12)
    assert roofline.RING_FACTOR == _jax_roofline().RING_FACTOR


def test_no_tpu_figure_in_the_port():
    bad = re.compile(r"197e12|819e9|v5e|v5p|TPU v", re.I)
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not bad.search(line), f"{path.name}:{n}: {line}"


# -- one subprocess on fake meshes ---------------------------------------------

_SCRIPT = textwrap.dedent('''
    import json, sys
    from repro_torch.launch import dryrun as dr, hillclimb, report
    from repro_torch.launch import roofline, shapes
    from repro_torch.parallel import sharding as shd

    out = {}
    shapes.SHAPES["tiny"] = shapes.ShapeCase("tiny", 64, 8, "prefill")
    cfg = dr.cell_config("smollm-360m", reduced=True)
    out["cfg"] = dict(d=cfg.d_model, h=cfg.n_heads, kv=cfg.kv_heads,
                      hd=cfg.hd, ff=cfg.d_ff, vocab=cfg.vocab,
                      layers=cfg.n_layers)

    def counted(settings):
        dr.TRAIN_SETTINGS["smollm-360m"] = settings
        with dr.analysis_mesh(shape=(4, 2)) as mesh:
            fn, args = dr.build_lowerable("smollm-360m", "tiny", mesh,
                                          cfg=cfg)
            model, batch = args
            sd = model.state_dict()
            shares = []
            for t in list(sd.values()) + list(batch.values()):
                n = 1
                for size, p in zip(mesh.shape, t.placements):
                    n *= size if p.is_shard() else 1
                shares.append(t.numel() * t.element_size() / n)
            c = dr.count(fn, args)
        c["shares"] = sum(shares)
        c["global"] = sum(t.numel() * t.element_size()
                          for t in list(sd.values()) + list(batch.values()))
        return c

    out["default"] = counted(dict(fsdp=False))
    out["replicated"] = counted(dict(rules={k: None for k in
                                            shd.DEFAULT_RULES}))
    out["fsdp"] = counted(dict(fsdp=True))
    dr.TRAIN_SETTINGS.pop("smollm-360m")

    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dr.analysis_mesh(shape=(8, 1)) as mesh:
        rows = [Shard(0), Replicate()]
        x = DTensor.from_local(torch.empty(32, 64, device="meta"), mesh,
                               rows, run_check=False)
        w = DTensor.from_local(torch.empty(8, 32, device="meta"), mesh,
                               rows, run_check=False)
        out["implicit"] = dr.count(lambda a, b: a @ b, (x, w))

    from repro_torch.models import recurrent
    chunk, recurrent.CHUNK = recurrent.CHUNK, 16
    shapes.SHAPES["loop"] = shapes.ShapeCase("loop", 80, 8, "train")
    xcfg = dr.cell_config("xlstm-1.3b", reduced=True)
    dr.TRAIN_SETTINGS["xlstm-1.3b"] = dict(fsdp=False, microbatches=1)
    with dr.analysis_mesh(shape=(4, 2)) as mesh:
        out["loop_fit"] = dr.count_cell("xlstm-1.3b", "loop", mesh, xcfg)
        out["loop_direct"] = dr.count(*dr.build_lowerable(
            "xlstm-1.3b", "loop", mesh, cfg=xcfg))
    dr.TRAIN_SETTINGS.pop("xlstm-1.3b")
    recurrent.CHUNK = chunk

    res, flags = sys.argv[1], ["--reduced", "--mesh-shape", "4x2",
                               "--results", sys.argv[1]]
    codes = {}
    for name, main, argv in (
            ("dryrun", dr.main, ["--arch", "smollm-360m", "--shape",
                                 "decode_32k"] + flags),
            ("roofline", roofline.main, ["--arch", "smollm-360m",
                                         "--shape", "train_4k"] + flags),
            ("hillclimb", hillclimb.main, ["--cell", "A", "--iters",
                                           "w4-bitplane-weights"] + flags),
            ("report", report.main, ["--results", res])):
        try:
            main(argv)
            codes[name] = 0
        except SystemExit as e:
            codes[name] = e.code
    out["codes"] = codes
    print("RESULT " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    res = tmp_path_factory.mktemp("results")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(res)], capture_output=True,
        text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    r = json.loads(line[-1][len("RESULT "):])
    r["dir"], r["stdout"] = res, out.stdout
    return r


def test_forward_flops_are_a_hand_count(fake):
    """The tiny prefill (8 x 64 tokens) on the (4, 2) mesh: the batch is
    split over data (4) and the query heads, attention and FFN over
    model (2), so one rank does an eighth of those products; the K and
    V projections (``kv_heads`` is replicated by the rules) a quarter.
    The tied head's input is still a partial sum over model (the FFN's
    row-parallel output, left unreduced through the final norm), so
    `DTensor` gathers the vocab-sharded table and each rank multiplies
    its batch rows by all of it: a quarter."""
    c = fake["cfg"]
    b, s = 8, 64
    t = b * s
    eighths = 2 * t * (c["d"] * c["h"] * c["hd"]
                       + c["h"] * c["hd"] * c["d"]
                       + 3 * c["d"] * c["ff"])
    eighths += 2 * 2 * b * c["h"] * s * s * c["hd"]       # QK^T and PV
    quarters = 2 * t * 2 * c["d"] * c["kv"] * c["hd"]
    head = 2 * b * c["d"] * c["vocab"]                    # last token only
    want = (c["layers"] * (eighths / 8 + quarters / 4) + head / 4)
    assert fake["default"]["flops"] == want


def test_an_implicit_gather_is_counted(fake):
    """x [256, 64] split over data (8 ranks) times an FSDP weight
    [64, 32] split over data, with no `constrain`: `DTensor` gathers the
    weight inside the product, so one rank receives the whole weight
    and multiplies its 32 rows by it."""
    c = fake["implicit"]
    assert c["coll"] == {"all-gather": 64 * 32 * 4}
    assert c["flops"] == 2 * 32 * 64 * 32
    assert c["bytes"] == (32 * 64 + 64 * 32 + 32 * 32) * 4


def test_a_token_loop_is_counted_at_three_lengths(fake):
    """xLSTM's sLSTM loops over the tokens, so its train and prefill cells
    are counted at three lengths of whole mLSTM chunks and extrapolated.
    With 16-token chunks, the train step of the reduced xLSTM at 80
    tokens, fitted through 32, 48 and 64, is its direct count: FLOPs,
    bytes (quadratic in the length: the loop's backward writes a
    gradient of the whole sequence each token), collectives and
    argument and output bytes."""
    fit, direct = fake["loop_fit"], fake["loop_direct"]
    assert fit["lengths"] == [32, 48, 64]
    for key in ("flops", "bytes", "coll", "argument_bytes",
                "output_bytes"):
        assert fit[key] == direct[key], key


def test_replicated_rules_move_nothing_and_fsdp_gathers(fake):
    assert fake["replicated"]["coll"] == {}
    assert fake["fsdp"]["coll"].get("all-gather", 0) > 0
    assert fake["default"]["coll"] == {} or all(
        v > 0 for v in fake["default"]["coll"].values())


def test_argument_bytes_are_the_local_shards(fake):
    for case in ("default", "replicated", "fsdp"):
        assert fake[case]["argument_bytes"] == fake[case]["shares"], case
    assert fake["replicated"]["argument_bytes"] == \
        fake["replicated"]["global"]
    assert fake["default"]["argument_bytes"] < fake["default"]["global"]
    assert fake["default"]["temp_bytes"] > 0


def test_the_clis_run_on_reduced_cells(fake):
    assert fake["codes"] == {"dryrun": 0, "roofline": 0, "hillclimb": 0,
                             "report": 0}
    d = fake["dir"]
    cell = json.loads((d / "dryrun" /
                       "smollm-360m__decode_32k__single.json").read_text())
    assert cell["ok"] and cell["n_chips"] == 8 and cell["reduced"]
    assert cell["memory_analysis"]["argument_bytes"] > 0
    roof = json.loads((d / "roofline" /
                       "smollm-360m__train_4k.json").read_text())
    assert roof["step_time_lower_bound_s"] == max(
        roof["compute_s"], roof["memory_s"], roof["collective_s"]) > 0
    log = json.loads((d / "hillclimb" /
                      "A_gemma3-27b_decode_32k.json").read_text())
    assert [it["name"] for it in log["iterations"]] == \
        ["baseline", "w4-bitplane-weights"]
    assert set(log["iterations"][1]["delta"]) == {
        "compute_s", "memory_s", "collective_s", "step_time_lower_bound_s"}
    assert "| smollm-360m | train_4k |" in fake["stdout"]
    assert "OK  smollm-360m" in fake["stdout"]


def test_fake_group_is_gone_and_refuses_a_running_group():
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _free_port
    assert not dist.is_initialized()
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="process group is running"):
            with dryrun.fake_group(8):
                pass
    finally:
        dist.destroy_process_group()
