"""Image pyramid: separable Gaussian blur + bilinear rescale.

Equivalent of ``ORBextractor::ComputePyramid`` (ORBextractor.cc:1171) and the
7x7 sigma-2 Gaussian used before descriptor sampling
(ORBextractor.cc:computeDescriptors).  XLA fuses the separable
convolutions.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def _gauss_kernel(ksize: int, sigma: float) -> tuple[float, ...]:
    half = ksize // 2
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-half, half + 1)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def gaussian_blur(img: jax.Array, ksize: int = 7, sigma: float = 2.0) -> jax.Array:
    """Separable Gaussian blur of a 2D image (replicate padding)."""
    k = jnp.asarray(_gauss_kernel(ksize, sigma), img.dtype)
    half = ksize // 2
    pad = jnp.pad(img, ((half, half), (0, 0)), mode="edge")
    # vertical pass: sum of shifted rows (unrolled small k — XLA fuses)
    out = jnp.zeros_like(img)
    for i in range(ksize):
        out = out + k[i] * jax.lax.dynamic_slice_in_dim(pad, i, img.shape[0], 0)
    pad = jnp.pad(out, ((0, 0), (half, half)), mode="edge")
    out2 = jnp.zeros_like(img)
    for i in range(ksize):
        out2 = out2 + k[i] * jax.lax.dynamic_slice_in_dim(pad, i, img.shape[1], 1)
    return out2


def resize_bilinear(img: jax.Array, shape: tuple[int, int]) -> jax.Array:
    return jax.image.resize(img, shape, method="bilinear")


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (height, width) list."""
    shapes = []
    for lv in range(n_levels):
        f = 1.0 / (scale**lv)
        shapes.append((max(16, int(round(h * f))), max(16, int(round(w * f)))))
    return shapes


def build_pyramid(
    img: jax.Array, n_levels: int = 8, scale: float = 1.2
) -> list[jax.Array]:
    """List of ``n_levels`` images; level 0 is the input (float32 [0,255]).

    Successive downscale from the previous level (like the reference) keeps
    the effective anti-aliasing of a blur+decimate chain.
    """
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img.astype(jnp.float32)]
    for lv in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lv]))
    return levels
