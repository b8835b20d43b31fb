"""Motion compensation: half/quarter-pel luma + 1/8-pel chroma, batched.

Reference: /root/reference/common/mc.c (hpel_filter:167, mc_luma:197,
get_ref:220, mc_chroma:246). Batched redesign:

- The three half-pel planes (H, V, C) are produced once per reference
  frame as whole-plane separable 6-tap filters (pure VPU work, XLA-fused).
- Quarter-pel samples are the spec average of two of the four planes
  {F,H,V,C}; per-MB blocks are fetched with batched gathers, with the
  plane pair / offsets derived arithmetically from the qpel phase
  (equivalent of x264's hpel_ref0/hpel_ref1 tables, mc.c:24-34).
- All planes carry a PAD-pixel replicated border so any clamped MV
  gathers in bounds (x264 pads 32, frame.c:29-60).

All filters are the normative spec 8.4.2.2 integer math.
"""

from __future__ import annotations

import jax.numpy as jnp

PAD = 24  # fullpel border; supports |mv| up to PAD-8 beyond frame edge


def pad_plane(p: jnp.ndarray, pad: int = PAD) -> jnp.ndarray:
    """Edge-replicate pad (x264_frame_expand_border, frame.c:246-310)."""
    return jnp.pad(p, ((pad, pad), (pad, pad)), mode="edge")


def _filt6(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def hpel_planes(full_padded: jnp.ndarray):
    """Compute H (x+1/2), V (y+1/2), C (x+1/2,y+1/2) planes from a padded
    full-pel plane. Returns (H, V, C) same shape (border columns/rows are
    garbage within the last 3 pixels of the pad — harmless given PAD).

    Normative: b=(E-5F+20G+20H-5I+J), pixel=(b+16)>>5 clipped; center j
    from intermediate sums with (j+512)>>10 (spec 8.4.2.2.1).
    """
    p = full_padded.astype(jnp.int32)

    def shift_x(img, k):
        return jnp.roll(img, -k, axis=1)

    def shift_y(img, k):
        return jnp.roll(img, -k, axis=0)

    # horizontal intermediate: sample between x and x+1
    th = _filt6(shift_x(p, -2), shift_x(p, -1), p,
                shift_x(p, 1), shift_x(p, 2), shift_x(p, 3))
    h = jnp.clip((th + 16) >> 5, 0, 255)
    # vertical intermediate
    tv = _filt6(shift_y(p, -2), shift_y(p, -1), p,
                shift_y(p, 1), shift_y(p, 2), shift_y(p, 3))
    v = jnp.clip((tv + 16) >> 5, 0, 255)
    # center: vertical 6-tap over horizontal intermediates
    tc = _filt6(shift_y(th, -2), shift_y(th, -1), th,
                shift_y(th, 1), shift_y(th, 2), shift_y(th, 3))
    c = jnp.clip((tc + 512) >> 10, 0, 255)
    return h, v, c


def gather_blocks(plane: jnp.ndarray, y0: jnp.ndarray, x0: jnp.ndarray,
                  bh: int, bw: int) -> jnp.ndarray:
    """Fetch [N, bh, bw] blocks at per-item top-left (y0, x0)."""
    ys = y0[:, None] + jnp.arange(bh)[None, :]          # [N, bh]
    xs = x0[:, None] + jnp.arange(bw)[None, :]          # [N, bw]
    return plane[ys[:, :, None], xs[:, None, :]]


def qpel_phase_tables(mvx, mvy):
    """Derive (plane1, dy1, dx1, plane2, dy2, dx2) from qpel phases.
    Planes: 0=F, 1=H, 2=V, 3=C. Spec 8.4.2.2.1 quarter-sample rules:
    odd-x averages the flanking {F/V, H/C} pair; odd-both averages H/V."""
    fx, fy = mvx & 3, mvy & 3
    ox, oy = fx & 1, fy & 1

    even_idx = (fx >> 1) + 2 * (fy >> 1)
    p1 = jnp.where(ox & oy, 1,
                   jnp.where(ox == 1, 1 + 2 * (fy >> 1),
                             jnp.where(oy == 1, (fx >> 1) + 2, even_idx)))
    p2 = jnp.where(ox & oy, 2,
                   jnp.where(ox == 1, 2 * (fy >> 1),
                             jnp.where(oy == 1, (fx >> 1), even_idx)))
    d1y = jnp.where((ox & oy) & (fy == 3), 1, 0)
    d1x = jnp.zeros_like(fx)
    d2y = jnp.where((ox == 1) | (ox & oy), 0,
                    jnp.where(fy == 3, 1, 0))
    d2x = jnp.where(((ox == 1) & (fx == 3)) | ((ox & oy) & (fx == 3)), 1, 0)
    return p1, d1y, d1x, p2, d2y, d2x


def mc_luma(planes: jnp.ndarray, mb_y0: jnp.ndarray, mb_x0: jnp.ndarray,
            mv: jnp.ndarray, bh: int = 16, bw: int = 16) -> jnp.ndarray:
    """Motion-compensate [N] luma blocks.

    planes: [4, Hp, Wp] stacked (F,H,V,C), PAD-padded.
    mb_y0/mb_x0: [N] block top-left in unpadded coords.
    mv: [N, 2] (mvx, mvy) in quarter-pel units.
    Returns [N, bh, bw] int32.
    """
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = mb_x0 + PAD + (mvx >> 2)
    iy = mb_y0 + PAD + (mvy >> 2)
    p1, d1y, d1x, p2, d2y, d2x = qpel_phase_tables(mvx, mvy)

    n = mvx.shape[0]
    ys1 = (iy + d1y)[:, None] + jnp.arange(bh)[None, :]
    xs1 = (ix + d1x)[:, None] + jnp.arange(bw)[None, :]
    ys2 = (iy + d2y)[:, None] + jnp.arange(bh)[None, :]
    xs2 = (ix + d2x)[:, None] + jnp.arange(bw)[None, :]
    s1 = planes[p1[:, None, None], ys1[:, :, None], xs1[:, None, :]]
    s2 = planes[p2[:, None, None], ys2[:, :, None], xs2[:, None, :]]
    return (s1 + s2 + 1) >> 1


def mc_chroma(plane_padded: jnp.ndarray, mb_y0: jnp.ndarray,
              mb_x0: jnp.ndarray, mv: jnp.ndarray,
              bh: int = 8, bw: int = 8) -> jnp.ndarray:
    """1/8-pel bilinear chroma MC (spec 8.4.2.2.2; mc.c:246-300).

    plane_padded: [Hp, Wp] PAD-padded chroma plane.
    mb_y0/mb_x0: [N] top-left in unpadded chroma coords.
    mv: [N, 2] *luma* quarter-pel MV (chroma eighth-pel == same integer).
    """
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = mb_x0 + PAD + (mvx >> 3)
    iy = mb_y0 + PAD + (mvy >> 3)
    fx = (mvx & 7)[:, None, None]
    fy = (mvy & 7)[:, None, None]
    a = gather_blocks(plane_padded, iy, ix, bh, bw)
    b = gather_blocks(plane_padded, iy, ix + 1, bh, bw)
    c = gather_blocks(plane_padded, iy + 1, ix, bh, bw)
    d = gather_blocks(plane_padded, iy + 1, ix + 1, bh, bw)
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * c + fx * fy * d + 32) >> 6


def mc_luma_multi(planes_r: jnp.ndarray, ref_idx: jnp.ndarray,
                  mb_y0: jnp.ndarray, mb_x0: jnp.ndarray,
                  mv: jnp.ndarray, bh: int = 16,
                  bw: int = 16) -> jnp.ndarray:
    """Multi-reference luma MC: planes_r [R, 4, Hp, Wp] stacked DPB,
    ref_idx [N] per-block L0 reference index (x264 i_ref per
    partition; reference me.c per-ref search loop analyse.c:1122)."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = mb_x0 + PAD + (mvx >> 2)
    iy = mb_y0 + PAD + (mvy >> 2)
    p1, d1y, d1x, p2, d2y, d2x = qpel_phase_tables(mvx, mvy)
    ys1 = (iy + d1y)[:, None] + jnp.arange(bh)[None, :]
    xs1 = (ix + d1x)[:, None] + jnp.arange(bw)[None, :]
    ys2 = (iy + d2y)[:, None] + jnp.arange(bh)[None, :]
    xs2 = (ix + d2x)[:, None] + jnp.arange(bw)[None, :]
    r = ref_idx[:, None, None]
    s1 = planes_r[r, p1[:, None, None], ys1[:, :, None], xs1[:, None, :]]
    s2 = planes_r[r, p2[:, None, None], ys2[:, :, None], xs2[:, None, :]]
    return (s1 + s2 + 1) >> 1


def mc_chroma_multi(plane_r: jnp.ndarray, ref_idx: jnp.ndarray,
                    mb_y0: jnp.ndarray, mb_x0: jnp.ndarray,
                    mv: jnp.ndarray, bh: int = 8,
                    bw: int = 8) -> jnp.ndarray:
    """Multi-reference chroma MC: plane_r [R, Hp, Wp]."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = mb_x0 + PAD + (mvx >> 3)
    iy = mb_y0 + PAD + (mvy >> 3)
    fx = (mvx & 7)[:, None, None]
    fy = (mvy & 7)[:, None, None]

    def gat(y0, x0):
        ys = y0[:, None] + jnp.arange(bh)[None, :]
        xs = x0[:, None] + jnp.arange(bw)[None, :]
        return plane_r[ref_idx[:, None, None], ys[:, :, None],
                       xs[:, None, :]]

    a = gat(iy, ix)
    b = gat(iy, ix + 1)
    c = gat(iy + 1, ix)
    d = gat(iy + 1, ix + 1)
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * c + fx * fy * d + 32) >> 6


def build_ref(recon_y: jnp.ndarray, recon_u: jnp.ndarray,
              recon_v: jnp.ndarray):
    """Package a reconstructed frame as a reference: padded planes +
    hpel pyramid (x264_fdec_filter_row's hpel step, encoder.c:1039-1048)."""
    fp = pad_plane(recon_y.astype(jnp.int32))
    h, v, c = hpel_planes(fp)
    return {
        "luma": jnp.stack([fp, h, v, c]),
        "u": pad_plane(recon_u.astype(jnp.int32)),
        "v": pad_plane(recon_v.astype(jnp.int32)),
    }
