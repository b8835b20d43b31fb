"""MV-field complexity cost: S-UNIWARD-style wavelet residual distortion.

The reference computes this through a prebuilt binary, `S-UNIWARD.lib`
(`get_cost_lib_for_x264`, extern at /root/reference/encoder/encoder.c:38;
no source ships — only the dead conv machinery in mat2D.h:283-376 hints
at its internals). Per SURVEY.md §7 hard-part #5, this is a re-derivation
from the published S-UNIWARD definition (Holub & Fridrich 2012):

    rho(i,j) = sum_k  ( 1 / (|X (*) F_k| + sigma) ) (*) |rot180(F_k)|

with F_k the three first-level Daubechies-8 directional filters
(LH, HL, HH outer products), mirror-padded "same" correlation
(mat2D.h Correlation_Same + Padding_Mirror semantics), sigma = 1.

Applied to the dense per-4x4 MV field (mv_h, mv_v as two single-channel
images, encoder.c:1285-1439); the two channels' costs are averaged.
Because the reference ships with alpha_com = 0 (encoder.c:1652), this
term is off by default and its exact scale does not affect parity; it is
exposed through StegoParams.alpha_com.

Everything is jax convs that XLA compiles as they stand; no kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

# Daubechies-8 decomposition high-pass (16 taps, public constants)
_HPDF = np.array([
    -0.0544158422, 0.3128715909, -0.6756307363, 0.5853546837,
    0.0158291053, -0.2840155430, -0.0004724846, 0.1287474266,
    0.0173693010, -0.0440882539, -0.0139810279, 0.0087460940,
    0.0048703530, -0.0003917404, -0.0006754494, -0.0001174768,
])
# low-pass via QMF relation lpdf[i] = (-1)^i * hpdf[N-1-i]
_LPDF = ((-1.0) ** np.arange(16)) * _HPDF[::-1]


def _filters():
    lh = np.outer(_LPDF, _HPDF)   # horizontal detail
    hl = np.outer(_HPDF, _LPDF)   # vertical detail
    hh = np.outer(_HPDF, _HPDF)   # diagonal
    return [lh, hl, hh]


def _mirror_pad(x, pr, pc):
    return jnp.pad(x, ((pr, pr), (pc, pc)), mode="symmetric")


def _corr_same(x, k):
    """'Same' correlation with mirror padding (mat2D.h:283-325 + :347)."""
    kr, kc = k.shape
    top = -(-(kr - 1) // 2)    # ceil
    left = -(-(kc - 1) // 2)
    xp = _mirror_pad(x, max(top, kr - 1 - top), max(left, kc - 1 - left))
    out = jax.lax.conv_general_dilated(
        xp[None, None], jnp.asarray(k[::-1, ::-1])[None, None],
        window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        # float32 on the GPU would otherwise run in TF32 (~10 mantissa
        # bits): the host reference computes these in full precision
        precision=jax.lax.Precision.HIGHEST)[0, 0]
    # xp conv VALID yields (H + 2p - kr + 1); crop to align 'same' center
    ph = max(top, kr - 1 - top)
    pw = max(left, kc - 1 - left)
    r0 = ph - top
    c0 = pw - left
    return out[r0:r0 + x.shape[0], c0:c0 + x.shape[1]]


@functools.partial(jax.jit, static_argnames=("sigma",))
def uniward_cost(field: jnp.ndarray, sigma: float = 1.0) -> jnp.ndarray:
    """Per-site embedding cost of a 2D field ([H4, W4] float)."""
    x = field.astype(jnp.float32)
    rho = jnp.zeros_like(x)
    for k in _filters():
        resid = _corr_same(x, k)
        inv = 1.0 / (jnp.abs(resid) + sigma)
        rho = rho + _corr_same(inv, np.abs(k[::-1, ::-1]))
    return rho


def mv_field_cost(mv_h: jnp.ndarray, mv_v: jnp.ndarray) -> jnp.ndarray:
    """rho_com over the dense 4x4-granularity MV field: average of the
    two components' UNIWARD costs."""
    return 0.5 * (uniward_cost(mv_h) + uniward_cost(mv_v))


def dense_mv_field(mv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rasterize per-MB 16x16 MVs into the per-4x4 dense field
    (encoder.c:1285-1330 D_16x16 case: each MB fills its 4x4 sites)."""
    mv_h = np.repeat(np.repeat(mv[..., 0], 4, 0), 4, 1).astype(np.float32)
    mv_v = np.repeat(np.repeat(mv[..., 1], 4, 0), 4, 1).astype(np.float32)
    return mv_h, mv_v
