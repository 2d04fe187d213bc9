"""Adjoint megakernel — material gradients at kernel speed.

diff/fast.py gets kernel-speed FORWARDS, but AD through the jnp twin stores
every bounce's residuals for its backward. This kernel computes the gradient for
the parameters production training optimizes (material albedo/emissive) by
HAND-DERIVING the path-space derivative and accumulating it inside the same
fused bounce loop the forward uses — no AD, no stored path state, one pass.

Derivation. Along a path, radiance = Σ_b T_b with T_b = mask_b ⊙ e_b, where
e_b is the bounce's emission (emissive·3, or bg on miss — GenerateColors.cl:
227,241) and mask_b = Π_{j<b} f_j·cosθ_j/pdf_j. EVERY brdf weight factors as
f_j = albedo_{c_j} ⊙ q_j with q_j albedo-independent (diffuse albedo/π —
GenerateColors.cl:204; GGX D/(4 cosi coso)·albedo·2 — :217), so per material
class c (channelwise):

    ∂mask/∂albedo_c  =: P_c   obeys the product rule, division-free:
    P_c' = (P_c ⊙ albedo_{hit} + [hit class = c]·mask) ⊙ (q·cosθ/pdf)

and the loss gradient for loss weights w_p = ∂loss/∂I_p accumulates per bounce

    g_albedo_c   += w ⊙ P_c ⊙ e_b        (e_b = emissive·boost on hit, bg on miss)
    g_emissive_c += w ⊙ mask · boost · [hit class = c]

Exact (not an estimator of an estimator): it is the derivative of the very
sum the forward computes, to f32 rounding. The final max(radiance, 0) clamp
(GenerateColors.cl:260) is treated as identity — path radiance is a sum of
nonnegative terms at physical parameters (albedo, emissive ≥ 0), so the clamp
never binds and its subgradient is 1; finite differences that step a zero
attribute NEGATIVE do cross the clamp and will read half the slope (this is
FD stepping outside the physical domain, not a kernel error — perturb upward
there).

On the GPU each lane carries its P_c and its own gradient sums in registers;
w is constant per lane, so it multiplies the lane's sums once at the end, and
the block reduces its lanes to one row of C×6 sums. Blocks carry nothing
between them; the rows are summed outside the kernel.

Class parameters, not per-material: the kernel differentiates w.r.t. the ≤16
deduplicated material CLASSES (megakernel.material_classes — the Cornell scene
trains 5), whose albedo/emissive arrive as a DYNAMIC (C, 8) table
(class_table) rather than the tp scan's baked constants — so a training step
never recompiles. Map class grads to per-material grads by summing over the
class's members if needed (chain rule of the class→material broadcast).

Restrictions: requires tp_scan_supported(scene) (the scan tracks a class
code); vertex gradients stay on the jnp + edge-sampling path (diff/edge.py) —
geometry terms do not factor through the mask product.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from oclpathtracer_tpu.config import RenderConfig
from oclpathtracer_tpu.kernels.megakernel import (
    BLOCK,
    TABLE_COLS,
    _cross3,
    _scalars,
    call_kernel,
    camera_path,
    decode_tp_tc,
    flat_table,
    lane_ids,
    lane_planes,
    material_classes,
    pack_scene_tp,
    shade,
    tp_fresh,
    tp_scan_supported,
    tri_tp,
)
from oclpathtracer_tpu.scene.types import Scene

CLASS_COLS = 8  # albedo[3] | emissive[3] | roughness | mtype


def pack_class_table(classes) -> jnp.ndarray:
    """(C, 8) f32 dynamic class-attribute table from material_classes output."""
    ct = np.zeros((len(classes), CLASS_COLS), np.float32)
    for i, (alb, emi, rough, mty) in enumerate(classes):
        ct[i, 0:3] = alb
        ct[i, 3:6] = emi
        ct[i, 6] = rough
        ct[i, 7] = mty
    return jnp.asarray(ct)


def prepare_grad_scene(scene: Scene):
    """(table, class_table, n_classes, mat_class) for the adjoint kernel.

    mat_class (M,) maps material records to class rows — the chain rule of
    class→material broadcast for callers that need per-material grads."""
    if not tp_scan_supported(scene):
        raise ValueError(
            "grad megakernel needs tp_scan_supported(scene) — the class-coded "
            "scan is how material attributes stay dynamic; fall back to the "
            "jnp train step (diff/inverse.py) for unsupported scenes")
    classes, mat_class = material_classes(scene)
    table, _ = pack_scene_tp(scene)
    return table, pack_class_table(classes), len(classes), jnp.asarray(mat_class)


def _make_kernel(cfg: RenderConfig, n_tris: int, n_samples: int, n_classes: int,
                 with_grads: bool = True):
    """Kernel body: dynamic-class tp forward; with_grads adds the adjoint.

    with_grads=False is the dynamic-class FORWARD (used for the pairwise
    loss's two renders before weights exist): the same image as the tp-scan
    megakernel, but with albedo/emissive as runtime inputs, so parameter
    updates never recompile."""
    C = n_classes
    bg = tuple(np.float32(c) for c in cfg.bg_color)
    eboost = np.float32(cfg.emissive_boost)

    def kernel(table_ref, class_ref, scal_ref, *rest):
        if with_grads:
            weight_ref, out_ref, grad_ref = rest
        else:
            (out_ref,) = rest

        def tl(j, c):
            return table_ref[j * TABLE_COLS + c]

        def cl(c, k):
            return class_ref[c * CLASS_COLS + k]

        classes = tuple(((cl(i, 0), cl(i, 1), cl(i, 2)),
                         (cl(i, 3), cl(i, 4), cl(i, 5)), cl(i, 6), cl(i, 7))
                        for i in range(C))
        pid = lane_ids(scal_ref[1])
        zeros = jnp.zeros((BLOCK,), jnp.float32)
        zero3 = (zeros, zeros, zeros)

        def bounce_cond(carry):
            b, path = carry[0], carry[1]
            return (b < cfg.bounces) & (jnp.max(path[4]) > 0.5)

        def bounce_body(carry):
            b, path, sg, P, G = carry
            sg = sg + path[4]
            o, d, mask = path[0], path[1], path[2]
            m = _cross3(o, d)
            tc = jax.lax.fori_loop(
                0, n_tris, lambda j, tc: tri_tp(tl, j, o, d, m, tc),
                tp_fresh(zeros))
            hit = decode_tp_tc(tc, classes)
            path, (active, miss, _, qf, alive) = shade(cfg, path, hit)
            if not with_grads:
                return b + 1, path, sg, P, G
            balb, bemi = hit[2], hit[3]
            # ∂loss contributions of this bounce's emission terms (per unit
            # loss weight): e_b = bemi·boost (hit) or bg (miss); ∂T_b/∂albedo_c
            # = P_c·e_b, ∂T_b/∂emissive_c = mask·boost·[hit class = c].
            e_vec = tuple(jnp.where(active, bemi[ch] * eboost, 0.0)
                          + jnp.where(miss, bg[ch], 0.0) for ch in range(3))
            newP, newG = [], []
            for c in range(C):
                sel = jnp.abs(tc[3] - (c + 1.0)) < 0.5
                sel_act = jnp.where(sel & active, eboost, 0.0)
                newG.append(tuple(G[c][ch] + P[c][ch] * e_vec[ch]
                                  for ch in range(3))
                            + tuple(G[c][3 + ch] + mask[ch] * sel_act
                                    for ch in range(3)))
                # Product rule for P_c = ∂mask/∂albedo_c (division-free):
                # P_c' = (P_c ⊙ albedo_hit + [hit=c]·mask) ⊙ qf on alive lanes.
                selc = jnp.where(sel, 1.0, 0.0)
                newP.append(tuple(
                    jnp.where(alive, (P[c][ch] * balb[ch] + selc * mask[ch])
                              * qf, P[c][ch]) for ch in range(3)))
            return b + 1, path, sg, tuple(newP), tuple(newG)

        def sample_body(s, acc):
            r0, g0, b0, sg, G = acc
            P = tuple(zero3 for _ in range(C)) if with_grads else ()
            _, path, sg, _, G = jax.lax.while_loop(
                bounce_cond, bounce_body,
                (jnp.int32(0), camera_path(cfg, pid, scal_ref[0] + s), sg, P,
                 G))
            rad = path[3]
            return (r0 + jnp.maximum(rad[0], 0.0),
                    g0 + jnp.maximum(rad[1], 0.0),
                    b0 + jnp.maximum(rad[2], 0.0), sg, G)

        G0 = (tuple(zero3 + zero3 for _ in range(C)) if with_grads else ())
        acc = jax.lax.fori_loop(0, n_samples, sample_body,
                                (zeros, zeros, zeros, zeros, G0))
        for c in range(4):
            out_ref[c, :] = acc[c]
        if with_grads:
            # Loss weights (per lane, per channel) times the lane's sums,
            # reduced over the block into one row of C×6 (padded) entries.
            w = (weight_ref[0, :], weight_ref[1, :], weight_ref[2, :])
            slot = jax.lax.broadcasted_iota(jnp.int32, (1, grad_ref.shape[1]),
                                            1)
            row = jnp.zeros((1, grad_ref.shape[1]), jnp.float32)
            for c in range(C):
                for k in range(6):
                    s = jnp.sum(w[k % 3] * acc[4][c][k])
                    row = jnp.where(slot == c * 6 + k, s, row)
            grad_ref[...] = row

    return kernel


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples", "n_classes",
                                             "with_grads", "n_rays"))
def render_grads_pallas(table: jnp.ndarray, class_table: jnp.ndarray,
                        cfg: RenderConfig, start_sample, n_samples: int,
                        n_classes: int, weight: jnp.ndarray | None = None,
                        with_grads: bool = True, pid_base=0,
                        n_rays: int | None = None):
    """SUM image of n_samples frames (+ loss gradients w.r.t. class attrs).

    weight: (n_rays, 3) = ∂loss/∂I per pixel (pass None with
    with_grads=False for a pure dynamic-class forward). Returns
    (img (n_rays, 3), grads (C, 6) or None) where grads[:, 0:3] = ∂loss/∂class
    albedo and grads[:, 3:6] = ∂loss/∂class emissive, for the UNNORMALIZED
    n_samples-frame sum the img output is (divide by n_samples for the mean).
    pid_base/n_rays: shard_map tiling as in megakernel (absolute-id RNG).
    """
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    n_pad = pl.cdiv(n_pix, BLOCK) * BLOCK
    nb = n_pad // BLOCK
    C = n_classes
    kernel = _make_kernel(cfg, int(table.shape[0]), n_samples, C,
                          with_grads=with_grads)
    whole = (flat_table(table), flat_table(class_table),
             _scalars(start_sample, pid_base))
    if not with_grads:
        out = call_kernel(kernel, whole, (), n_pad)
        return out[:3, :n_pix].T, None
    if weight is None:
        weight = jnp.zeros((n_pix, 3), jnp.float32)
    # Padded lanes carry zero weight, so summing every lane is exact.
    width = pl.next_power_of_2(C * 6)
    out, grads = call_kernel(kernel, whole, (lane_planes(weight, n_pad),),
                             n_pad, extra_out=((1, width), lambda i: (i, 0),
                                        (nb, width)))
    return out[:3, :n_pix].T, jnp.sum(grads, axis=0)[:C * 6].reshape(C, 6)
