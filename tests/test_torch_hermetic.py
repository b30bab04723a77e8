# test_torch_hermetic.py — the port runs with no JAX package, JAX, OpenCV,
# Triton, matplotlib or shapely.
"""Every module of reasoning_image_generation_tpu_torch imports, its RPM CLI
writes a dataset on the CPU at the default 512x512 canvas (one process,
the same with ``--sparse``, and two host shards merged), ``Shape.draw``
draws a shape over an ndarray texture, its multigraph CLI writes a
dataset at dpi 25 (through its rle4 transfer), and the RPM generator
writes grids on a device mesh of two handles to the CPU, in a process
where the JAX package
(``reasoning_image_generation_tpu``), ``jax``, ``cv2``, ``triton``,
``matplotlib`` and ``shapely`` cannot be imported.  Devices are chosen
only by name: CUDA without a card raises."""
import glob
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from reasoning_image_generation_tpu_torch import cli
from reasoning_image_generation_tpu_torch.device import resolve_device
from reasoning_image_generation_tpu_torch.io import png
from reasoning_image_generation_tpu_torch.io.png_read import read_png

from .conftest import REPO_ROOT

torch.set_num_threads(1)

BLOCKED = ("reasoning_image_generation_tpu", "jax", "cv2", "triton",
           "matplotlib", "shapely")
MG_MODES = ("random", "nested", "adjacent", "intersecting")

_CHILD = """
import importlib, json, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import reasoning_image_generation_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from reasoning_image_generation_tpu_torch import cli
cli.main(["--device", "cpu", "--n", "2", "--batch_size", "2", "--seed", "0",
          "--out_dir", {out!r}])
cli.main(["--device", "cpu", "--n", "2", "--batch_size", "2", "--seed", "0",
          "--sparse", "--out_dir", {out_sparse!r}])
for host in ("0", "1"):
    cli.main(["--device", "cpu", "--n", "2", "--batch_size", "1", "--seed", "0",
              "--grid_only", "--dedup", "--num_hosts", "2", "--host_id", host,
              "--out_dir", {out2!r}])
import numpy as np
from reasoning_image_generation_tpu_torch.models.rpm.shapes import Shape
texture = np.random.default_rng(0).integers(0, 256, (9, 7, 3)).astype(np.uint8)
drawn = Shape("star", 40, True, 2).draw(
    np.full((64, 80, 3), 255, np.uint8), (70, 30), angle=20.0,
    color=(40, 80, 200), device="cpu", texture=texture, external_mode="tile",
    antialias_mode="soft")
np.save({drawn!r}, drawn)
from reasoning_image_generation_tpu_torch.models.multigraph import cli as mg_cli
mg_cli.main(["--device", "cpu", "--n", "4", "--batch_size", "3", "--dpi", "25",
             "--modes", {modes!r}, "--out_dir", {out_mg!r}])
from reasoning_image_generation_tpu_torch.models.rpm.generator import RPMGenerator
from reasoning_image_generation_tpu_torch.parallel.mesh import make_mesh
from reasoning_image_generation_tpu_torch.utils.config import GenConfig
gen = RPMGenerator(GenConfig(out_dir={out_mesh!r}, seed=0, batch_size=2,
                             canvas_size=(128, 128), grid_only=True),
                   torch.device("cpu"), mesh=make_mesh(devices=["cpu", "cpu"]))
mesh_metas = gen.generate_ids([0, 1, 2], dedup=True)
gen.close()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
print(json.dumps({{"modules": mods, "loaded": loaded,
                  "mesh_ids": [m["id"] for m in mesh_metas
                               if not m.get("error")]}}))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    out = str(tmp_path / "out")
    out_mg = str(tmp_path / "out_mg")
    out2 = str(tmp_path / "out_two_hosts")
    out_sparse = str(tmp_path / "out_sparse")
    out_mesh = str(tmp_path / "out_mesh")
    drawn = str(tmp_path / "drawn.npy")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(
            blocked=BLOCKED, out=out, out_mg=out_mg, out2=out2, drawn=drawn,
            out_sparse=out_sparse, out_mesh=out_mesh,
            modes=",".join(MG_MODES))],
        cwd=str(REPO_ROOT), capture_output=True, text=True, timeout=400,
        env={**os.environ, "RIG_TORCH_CACHE": str(tmp_path / "stats")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    # the RPM generator on a mesh of two handles to the CPU
    assert report["mesh_ids"] == [0, 1, 2]
    assert len(glob.glob(f"{out_mesh}/grids/*.png")) == 3
    for m in ("cli", "device", "ops.raster", "ops.raster_cuda", "ops.compose",
              "ops.cuda_build", "ops.geometry", "ops.phash", "io.png",
              "io.writer", "models.rpm.pipeline", "models.rpm.generator",
              "utils.config", "utils.prng", "utils.state",
              "ops.resize", "ops.overlay", "models.rpm.shapes",
              "parallel.mesh", "utils.profiling", "utils.logging",
              "models.multigraph.scene", "models.multigraph.renderer",
              "models.multigraph.renderer_cuda", "models.multigraph.check",
              "models.multigraph.generator", "models.multigraph.cli",
              "ops.rle", "ops.sparse", "io.transfer", "utils.cache"):
        assert f"reasoning_image_generation_tpu_torch.{m}" in report["modules"]
    assert not any(".tools" in m for m in report["modules"])
    pngs = sorted(glob.glob(f"{out_mg}/images/*.png"))
    params = sorted(glob.glob(f"{out_mg}/params/*.json"))
    assert len(pngs) == len(params) == 4
    for p in pngs:
        assert read_png(p).shape == (200, 200, 3)
    for p in params:
        with open(p, encoding="utf-8") as f:
            rec = json.load(f)
        assert rec["mode"] in MG_MODES and "qc" in rec
    with open(f"{out}/index.json", encoding="utf-8") as f:
        index = json.load(f)
    assert [m["id"] for m in index] == [0, 1]
    assert not any(m.get("error") for m in index)
    for m in index:
        assert {s["canvas_size"] == [512, 512] for s in m["sequence"]} == {True}
        assert read_png(m["grid_path"]).shape[1:] == (512, 3)
    # --sparse: the same samples, frames and grids through the rle4d codec
    with open(f"{out_sparse}/index.json", encoding="utf-8") as f:
        sparse_index = json.load(f)
    assert [m["grid_phash"] for m in sparse_index] == \
        [m["grid_phash"] for m in index]
    for m, ms in zip(index, sparse_index):
        for s, ss in zip(m["sequence"], ms["sequence"]):
            assert np.array_equal(read_png(s["state_path"]),
                                  read_png(ss["state_path"]))
        assert np.array_equal(read_png(m["grid_path"]),
                              read_png(ms["grid_path"]))
    assert sorted(os.listdir(tmp_path / "stats")) == [
        "runstats_mg.json", "runstats_rpm_512x512_g3_rle4d.json"]
    # the two host shards, merged by the host that came last
    with open(f"{out2}/index.json", encoding="utf-8") as f:
        merged = json.load(f)
    assert [m["id"] for m in merged] == [0, 1]
    assert sorted(glob.glob(f"{out2}/index_host*.json")) == [
        f"{out2}/index_host00.json", f"{out2}/index_host01.json"]
    assert [m["grid_phash"] for m in merged] == \
        [m["grid_phash"] for m in index]
    # Shape.draw: the star's colour and the texture both reached the canvas,
    # the star across the right edge
    img = np.load(drawn)
    assert img.shape == (64, 80, 3) and img.dtype == np.uint8
    assert (img == (40, 80, 200)).all(-1).sum() > 100
    assert (img[:, :5] != 255).any() and (img[:, 40] == 255).all()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        cli.main(["--n", "1"])                  # --device defaults to cuda
    assert resolve_device("cpu") == torch.device("cpu")


def test_device_defaults_and_choices():
    assert cli.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        cli.parse_args(["--device", "tpu"])
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("argv", [["--num_hosts", "2"],
                                  ["--coordinator", "localhost:1234"]])
def test_multi_host_flags_are_not_ported(argv, tmp_path):
    """The name is from when both flags raised NotImplementedError.  Now
    ``--num_hosts 2`` runs this host's shard and waits with the merge for
    the other's, and ``--coordinator`` ends in the JAX CLI's SystemExit."""
    out = str(tmp_path / "out")
    common = ["--device", "cpu", "--n", "2", "--batch_size", "1",
              "--grid_only", "--out_dir", out]
    if "--coordinator" in argv:
        with pytest.raises(SystemExit, match="--coordinator is not supported"):
            cli.main(common + argv)
        return
    cli.main(common + argv)                     # host 0 of 2
    with open(f"{out}/index_host00.json", encoding="utf-8") as f:
        shard = json.load(f)
    assert [m["id"] for m in shard["metas"]] == [0]
    assert glob.glob(f"{out}/index.json") == []


def _test_image():
    rng = np.random.default_rng(0)
    img = np.full((37, 53, 3), 255, np.uint8)
    img[5:30, 10:40] = (40, 80, 200)
    img[:, 20] = rng.integers(0, 256, (37, 3))
    img[12:20] = rng.integers(0, 256, (8, 53, 3))
    return img


def test_read_png_decodes_every_encoder(tmp_path):
    """read_png, which checks exports where no OpenCV is installed, against
    each encoder either package may pick: the port's fastpng and zlib, the
    JAX package's fastpng and zlib, and OpenCV (where present; it picks its
    own row filters)."""
    from reasoning_image_generation_tpu.io import native
    from reasoning_image_generation_tpu.io.png import encode_png_zlib
    img = _test_image()
    paths = {"fastpng": str(tmp_path / "f.png"), "zlib": str(tmp_path / "z.png"),
             "port": str(tmp_path / "p.png"),
             "port_zlib": str(tmp_path / "pz.png")}
    native.write_png(paths["fastpng"], img)
    with open(paths["zlib"], "wb") as f:
        f.write(encode_png_zlib(img))
    png.write_png(paths["port"], img)
    with open(paths["port_zlib"], "wb") as f:
        f.write(png.encode_png_zlib(img))
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        paths["cv2"] = str(tmp_path / "c.png")
        cv2.imwrite(paths["cv2"], img[..., ::-1])
    for name, path in paths.items():
        assert np.array_equal(read_png(path), img), name


def test_png_encoder_falls_back_to_zlib_without_a_compiler(tmp_path,
                                                          monkeypatch,
                                                          caplog):
    """Without a C compiler the port writes PNGs with zlib and says so,
    once; with one it builds csrc/fastpng.c outside the source tree."""
    img = _test_image()
    monkeypatch.setattr(png, "_encoder", None)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with caplog.at_level(logging.INFO, logger=png.__name__):
        png.write_png(str(tmp_path / "a.png"), img)
        png.write_png(str(tmp_path / "b.png"), img)
    assert png.encoder() == "zlib"
    assert [r.getMessage().split(" (")[0] for r in caplog.records] == \
        ["PNG encoder: zlib"]
    for name in ("a.png", "b.png"):
        assert np.array_equal(read_png(str(tmp_path / name)), img)
    monkeypatch.setattr(png, "_encoder", None)
    monkeypatch.delenv("CC")
    if png.encoder() == "fastpng":
        assert png.build().startswith(png.cuda_build.BUILD_DIR)
