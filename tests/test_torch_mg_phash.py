# test_torch_mg_phash.py — pHash of 1600x1600 mg canvases against the JAX package.
"""The port's ``ops/phash.phash`` against the JAX package's ``phash_batch`` on
numpy-seeded 1600x1600 images, the mg pipeline's canvas (its dedup hashes
the rendered batch): white canvases with random strokes and noise.
Exact."""
import numpy as np
import torch

from reasoning_image_generation_tpu.ops.phash import phash_batch
from reasoning_image_generation_tpu_torch.ops.phash import phash

torch.set_num_threads(1)

S = 1600


def _images(n: int = 3) -> np.ndarray:
    rng = np.random.default_rng(7)
    imgs = np.full((n, S, S, 3), 255, np.uint8)
    for img in imgs:
        for _ in range(12):
            y, x = rng.integers(0, S - 200, 2)
            h, w = rng.integers(2, 200, 2)
            img[y:y + h, x:x + w] = rng.integers(0, 256, 3)
        y = rng.integers(0, S - 64)
        img[y:y + 64] = rng.integers(0, 256, (64, S, 3))
    return imgs


def test_phash_matches_jax_at_1600():
    imgs = _images()
    want = np.asarray(phash_batch(imgs))
    got = phash(torch.from_numpy(imgs)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len({bytes(h) for h in got}) == len(got)
