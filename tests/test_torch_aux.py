# test_torch_aux.py — the port's logging and profiling helpers.
"""utils/logging.py and utils/profiling.py of the port: the cases of
tests/test_aux.py that concern them, on the port's modules.  No numbers are
compared with the JAX package here: both write wall-clock times.  The trace
that ``--profile_dir`` writes is in tests/test_torch_cli_multihost.py, the
program's spans in it in tests/test_torch_spans.py."""
import json

import torch

from reasoning_image_generation_tpu_torch.utils.logging import (
    JsonFormatter, setup_logger)
from reasoning_image_generation_tpu_torch.utils.profiling import trace

torch.set_num_threads(1)


def test_json_logger(tmp_path):
    jf = str(tmp_path / "log.jsonl")
    pf = str(tmp_path / "log.txt")
    logger = setup_logger("rig_torch_test", log_file=pf, json_log_file=jf)
    logger.info("hello %s", "world")
    try:
        raise ValueError("boom")
    except ValueError:
        logger.exception("failed")
    # a second set-up adds no handler
    assert setup_logger("rig_torch_test", log_file=pf,
                        json_log_file=jf) is logger
    assert len(logger.handlers) == 3 and not logger.propagate
    assert isinstance(logger.handlers[2].formatter, JsonFormatter)
    for h in logger.handlers:
        h.flush()
    with open(jf, encoding="utf-8") as f:
        first, second = (json.loads(l) for l in f.read().strip().splitlines())
    assert first["message"] == "hello world" and first["level"] == "INFO"
    assert {"timestamp", "logger", "path", "func", "line"} <= set(first)
    assert "exc_info" not in first and "ValueError: boom" in second["exc_info"]
    with open(pf, encoding="utf-8") as f:
        assert "hello world" in f.read()


def test_trace_is_a_noop_without_a_directory(tmp_path):
    for falsy in (None, ""):
        with trace(falsy):
            x = 1
        assert x == 1
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_one_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    with open(files[0], encoding="utf-8") as f:
        assert "traceEvents" in json.load(f)
