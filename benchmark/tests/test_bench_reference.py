# test_bench_reference.py — the frozen plain reference agrees with the
# port's own CPU path at the configurations' sizes, on the card with its
# own CPU path, and its control (one step of precision lower, in the
# program's place) fails a run's check.
import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH


def cell(name):
    from benchlib import common
    return common.load_cell(name, BENCH)


def test_rpm_reference_equals_the_ports_cpu_path():
    from benchlib import rpm
    from plainref.models.rpm import pipeline as ref_pipe
    from reasoning_image_generation_tpu_torch.models.rpm import pipeline
    from reasoning_image_generation_tpu_torch.utils.config import GenConfig
    c = cell("rpm_full_export")
    seed = 2 ** 31 + 101
    leaves, weights = rpm.leaves_of(c["config_data"])
    groups = rpm.assign(seed, range(40), leaves, weights)
    # one id of a four-frame leaf and one of a six-frame (overlay) leaf
    picks = [next(e for l, es in groups.items() for e in es
                  if rpm.seq_len(l) == n) for n in (4, 6)]
    cfg = rpm.gen_config(c, seed, "unused")
    assert isinstance(cfg, GenConfig) and not cfg.grid_only
    for sid, path, use_grid in picks:
        keys = pipeline.sample_keys(seed, [sid])
        ug = torch.tensor([use_grid])
        got = pipeline.LeafPipeline(path[-1], cfg).step(keys, ug)
        want = ref_pipe.LeafPipeline(path[-1], cfg).step(
            ref_pipe.sample_keys(seed, [sid]), ug)
        assert set(got) == set(want)
        for k in ("grid_img", "grid_phash", "state_imgs", "option_imgs",
                  "perm", "correct_index"):
            assert torch.equal(got[k], want[k]), (path[-1], k)
        for a, b in zip(got["states"], want["states"]):
            assert torch.equal(a, b)


def test_mg_reference_equals_the_ports_cpu_path():
    from benchlib import mg
    from reasoning_image_generation_tpu_torch.models.multigraph.check import (
        check_scene_inside)
    from reasoning_image_generation_tpu_torch.models.multigraph.renderer \
        import render_scene_batch
    from reasoning_image_generation_tpu_torch.models.multigraph.scene import (
        BOUNDS, build_scene_batch)
    c = cell("mg_four_modes")
    picked = [(0, 2 ** 31 + 7, "nested"), (1, 2 ** 31 + 8, "intersecting")]
    ref = mg.reference(c, picked, torch.device("cpu"))
    batch, metas = build_scene_batch([p[1] for p in picked],
                                     [p[2] for p in picked], 1.3)
    imgs = render_scene_batch(batch, 200, torch.device("cpu")).numpy()
    for j, (img, rec) in enumerate(ref):
        assert np.array_equal(img, imgs[j])
        scene = {k: v[j] for k, v in batch.items()}
        qc = json.loads(json.dumps(check_scene_inside(scene, BOUNDS,
                                                      dpi=200)))
        assert rec["qc"] == qc
        assert rec["shape_count"] == metas[j]["shape_count"]


def set_config(root, config, **settings):
    path = os.path.join(root, "benchmark", "configs", f"{config}.json")
    with open(path) as f:
        data = json.load(f)
    data["settings"].update(settings)
    with open(path, "w") as f:
        json.dump(data, f)


def control_run(root, cell, control, device_name="cpu"):
    import control as ctl
    return ctl.run_control(cell, 2 ** 31 + 3, control, 0.5,
                           device_name=device_name,
                           base=os.path.join(root, "benchmark"),
                           manifest_root=root)


# two rule leaves, one of four frames and one of six, so that the host
# renders few batches at 512 px
TWO_LEAVES = {"图形相似": {"位置变换": ["平移"], "叠加": ["直接叠加"]}}


def test_rpm_bf16_control_fails_the_cell(tiny_tree):
    """K1's frames rounded through bfloat16, written in the program's
    place, fail the unchanged check of a run (at 512 px, the cells' size:
    at 128 px the rounding moves no pixel)."""
    set_config(tiny_tree, "rpm_tiny", canvas_size=[512, 512],
               categories=TWO_LEAVES)
    out = control_run(tiny_tree, "tiny_full", "bf16_raster")
    assert out["correct"] is False
    assert out["checks"]["px_mismatch"]["value"] > 0
    assert out["checks"]["missing"]["value"] == 0


def test_mg_control_fails_the_cell(tiny_tree):
    """The bfloat16 control at a size a test holds (dpi 40): its pixels
    differ, so the cell's limit (0) fails it."""
    set_config(tiny_tree, "mg_tiny", dpi=40, canvas_px=320)
    out = control_run(tiny_tree, "tiny_mg", "bf16_raster")
    assert out["correct"] is False
    assert out["checks"]["px_mismatch"]["value"] > 0
    assert out["checks"]["json_mismatch"]["value"] == 0


def test_rpm_control_fails_the_cell(tiny_tree, card):
    """On the card, through the command line (a process a run): TF32 is
    in force under its control (at these sizes it may change no byte, see
    PERF.md), and the bfloat16 control fails."""
    import subprocess
    import sys
    from conftest import ROOT
    set_config(tiny_tree, "rpm_tiny", canvas_size=[512, 512],
               categories=TWO_LEAVES)
    p = subprocess.run(
        [sys.executable, os.path.join(tiny_tree, "benchmark", "control.py"),
         "--workload", "tiny_grid", "--seeds", str(2 ** 31 + 3),
         "--seconds", "0.5"], capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=ROOT))
    lines = {d["control"]: d for d in map(json.loads, p.stdout.splitlines())}
    assert set(lines) == {"tf32", "bf16_raster"}, p.stderr[-2000:]
    assert lines["tf32"]["tf32_product_maxdiff"] > 0
    assert lines["bf16_raster"]["correct"] is False


def test_reference_on_the_card_equals_the_reference_on_the_cpu(card):
    """The frozen reference decides ``correct`` on the card; the CPU tests
    hold its CPU path to the port's, which they hold to the JAX package.
    On the card it gives the same bytes at the cells' sizes: one id of
    every rule leaf with every frame (512 px), one scene of every mode
    (1600 px)."""
    from benchlib import compare, mg, rpm
    torch.set_num_threads(os.cpu_count() or 1)
    c = cell("rpm_full_export")
    seed = 2 ** 31 + 977
    leaves, weights = rpm.leaves_of(c["config_data"])
    groups = rpm.assign(seed, range(200), leaves, weights)
    picked = [es[0] for _l, es in sorted(groups.items())]
    assert len(picked) == len(leaves)
    on_card = rpm.reference(c, seed, picked, card, "unused")
    on_cpu = rpm.reference(c, seed, picked, torch.device("cpu"), "unused")
    for sid, _p, _u in picked:
        a, b = on_card[sid], on_cpu[sid]
        assert np.array_equal(a["grid"], b["grid"]), sid
        assert a["frames"].keys() == b["frames"].keys()
        for name in a["frames"]:
            assert np.array_equal(a["frames"][name], b["frames"][name])
        assert a["phash"] == b["phash"]
        # every field but the time stamps
        assert compare.json_diff(a["meta"], b["meta"], rpm.VOLATILE) == 0
        assert compare.json_diff(a["coco"], b["coco"], rpm.VOLATILE) == 0
    c = cell("mg_four_modes")
    modes = c["traffic"]["modes"]
    picked = [(j, 2 ** 31 + 31 + j, m) for j, m in enumerate(modes)]
    on_card = mg.reference(c, picked, card)
    on_cpu = mg.reference(c, picked, torch.device("cpu"))
    for (img_a, rec_a), (img_b, rec_b) in zip(on_card, on_cpu):
        assert np.array_equal(img_a, img_b)
        assert rec_a == rec_b
