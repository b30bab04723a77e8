# test_torch_writer.py — the port's JSON export against the JAX package's.
"""``ExportPool.submit_json`` of the port writes the bytes the JAX
package's writes, compact and pretty, threaded and synchronous, on an
object with Chinese keys and values (the leaf names), nesting, floats and
None.  Exact."""
import pytest

from reasoning_image_generation_tpu.io.writer import ExportPool as JaxPool
from reasoning_image_generation_tpu_torch.io.writer import ExportPool

OBJ = {"规则": "去同存异", "category_path": ["位置规律", "平移"],
       "cells": [{"bbox": [28, 20, 2, 2], "score": 0.125, "path": None}],
       "嵌套": {"是": True, "数": -3}}


@pytest.mark.parametrize("use_threads", [True, False])
@pytest.mark.parametrize("pretty", [False, True])
def test_submit_json_writes_the_jax_bytes(tmp_path, pretty, use_threads):
    paths = {}
    for name, cls in (("jax", JaxPool), ("port", ExportPool)):
        pool = cls(workers=2, use_threads=use_threads)
        paths[name] = tmp_path / f"{name}.json"
        pool.submit_json(str(paths[name]), OBJ, pretty=pretty)
        pool.close()
    want = paths["jax"].read_bytes()
    assert paths["port"].read_bytes() == want
    assert "去同存异".encode() in want
    assert (b"\n  " in want) == pretty
