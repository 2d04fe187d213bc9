"""Fused path-trace megakernel (Pallas; compiled through Triton on the GPU).

One program traces ENTIRE paths for a 1-D block of `BLOCK` pixels, one lane per
pixel — the shape of the reference's own kernel (GenerateColors.cl:302-322, one
work-item per pixel): camera ray, the whole bounce loop, the triangle scan, BRDF
sampling and the sum over samples all stay in registers. The scene table is read
by scalar loads from one global-memory ref; every lane of a block reads the same
row at the same time, so the L1 cache serves it. Device-memory traffic is one
(4, BLOCK) write per block: three radiance planes and the segment count.

Why a kernel beside the plain jnp integrator (integrators/path.py): that path
writes the ray state to device memory at every bounce and materializes (rays ×
tris) intermediates; here nothing leaves the registers between bounces. Whether
this pays is measured on the card (PERF.md).

Sample streams are the REFERENCE's exact RNG (kernels/rng.py): seed = pixel_id +
hash(frame), wang+LCG per draw — so this kernel is comparable draw for draw with
the jnp parity integrator (integrators/parity.py), and sharding-invariant
because pixel ids are absolute.

Semantics ≡ reference traceRays (GenerateColors.cl:223-261) with all quirks:
backface cull (:100), first-min hit (:144-150), emissive ×3 (:241), GGX ×2 (:217),
flat bg on miss (:227), 0.01 respawn offset (:257), ≤`bounces` segments.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from oclpathtracer_tpu.config import RenderConfig
from oclpathtracer_tpu.kernels import rng as krng
from oclpathtracer_tpu.kernels.route import pallas_params
from oclpathtracer_tpu.scene.types import Scene

# Pixels per program (one lane each; a power of two for Triton) and warps per
# program: 256 × 4 was best or within 3% of best for both kernels in a sweep
# of 128/256/512 lanes × 4/8 warps on the H100 (PERF.md).
BLOCK = 256
NUM_WARPS = 4

INV_PI = 0.31830988618
TWO_PI = 6.28318530718
T_MAX = 1e20

# Scene table layout (T, 24) f32 — columns:
#  0:3 p1 | 3:6 e1 | 6:9 e2 | 9:12 n=normalize(cross(e2,e1)) | 12:15 albedo
#  15:18 emissive | 18 roughness | 19 mtype (1.0 diffuse / 2.0 specular) |
#  20:23 pad | 23 fast-scan fused code = rough + 4*mtype + 16*is_emitter
#  (0 = "no hit"; requires roughness < 4 — see fast_scan_supported)
TABLE_COLS = 24


def pack_scene(scene: Scene) -> jnp.ndarray:
    """Flatten the scene pytree into the kernel's (T, 24) table."""
    g, m = scene.geometry, scene.materials
    p1 = np.asarray(g.p1, np.float32)
    e1 = np.asarray(g.p2, np.float32) - p1
    e2 = np.asarray(g.p3, np.float32) - p1
    n = np.cross(e2, e1)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    mid = np.asarray(g.mat_id)
    tbl = np.zeros((p1.shape[0], TABLE_COLS), np.float32)
    tbl[:, 0:3] = p1
    tbl[:, 3:6] = e1
    tbl[:, 6:9] = e2
    tbl[:, 9:12] = n
    tbl[:, 12:15] = np.asarray(m.albedo)[mid]
    tbl[:, 15:18] = np.asarray(m.emissive)[mid]
    tbl[:, 18] = np.asarray(m.roughness)[mid]
    tbl[:, 19] = np.asarray(m.mtype)[mid].astype(np.float32)
    # Fast-scan fused code (see scan="fast" in _make_kernel): rough/mtype/
    # is-emitter packed into one tracked channel; the shared emitter RGB is
    # baked into the kernel as a static constant (scene_emissive_const).
    is_emit = (np.asarray(m.emissive)[mid] != 0.0).any(axis=-1)
    tbl[:, 23] = tbl[:, 18] + 4.0 * tbl[:, 19] + 16.0 * is_emit
    return jnp.asarray(tbl)


def fast_scan_supported(scene: Scene) -> bool:
    """True if the scene's materials survive the fast scan's fused-code
    encoding exactly: every emitting material shares ONE emissive RGB (baked
    into the kernel as a constant — scene_emissive_const), roughness < 4 (so
    rough + 4*mtype + 16*is_emitter unpacks), and mtype is diffuse/specular.
    The reference's Cornell materials qualify (one light, emissive (30,30,30),
    RaytraceTest.cpp:147-153); scenes that don't fall back to the parity scan."""
    m = scene.materials
    emi = np.asarray(m.emissive)
    rough = np.asarray(m.roughness)
    mty = np.asarray(m.mtype)
    emitters = emi[(emi != 0.0).any(axis=-1)]
    return bool(
        (emitters.shape[0] == 0 or (emitters == emitters[0]).all())
        and np.all((rough >= 0.0) & (rough < 4.0))
        and np.all((mty == 1) | (mty == 2)))


def scene_emissive_const(scene: Scene) -> tuple[float, float, float]:
    """The shared emitter RGB the fast scan bakes in (0,0,0 if no emitters)."""
    emi = np.asarray(scene.materials.emissive)
    emitters = emi[(emi != 0.0).any(axis=-1)]
    if emitters.shape[0] == 0:
        return (0.0, 0.0, 0.0)
    return tuple(float(c) for c in emitters[0])


# ---- triple-product ("tp") scan: precomputed-constant intersection ----------
#
# Rewrites Möller–Trumbore's four scan outputs as triple products of HOST-
# precomputed per-triangle constants (algebra verified against the cross/dot
# form to 1e-6 over random triangles):
#   det  = d·N            N  = cross(e2, e1)   (the unnormalized normal —
#   tnum = k − o·N        k  = p1·N             det's sign test ≡ the parity
#   unum = e2·m − d·C1    C1 = cross(e2, p1)    scan's backface cull)
#   vnum = d·C2 − e1·m    C2 = cross(e1, p1)
# with ONE per-ray-per-bounce helper m = cross(o, d). This drops the two
# per-triangle cross products, and the tracked best-hit state shrinks to 6
# channels (t num/den, raw N ×3, material-CLASS code): albedo/emissive/
# roughness/mtype live in a deduplicated class table baked into the kernel as
# static constants and decoded once per bounce; the shading normal is
# normalize(N), also computed once per bounce at decode. Like the fast scan,
# hit decisions can differ from parity only at ulp comparison boundaries (the
# four outputs are algebraically equal but round differently); images are
# allclose. Requires tp_scan_supported(scene).

TP_CLASS_CAP = 16  # decode is an unrolled select chain — keep it short

# Numeric-extent gate for the tp scan. Its forms carry magnitudes that grow
# with the scene's distance from the world origin (tnum = k − o·N with
# k = p1·N; unum/vnum mix cross(o,d) with cross(e,p1)), unlike parity/fast
# which subtract o − p1 FIRST — so a scene sitting far from the origin
# catastrophically cancels in f32 where parity stays exact. Gate: every
# vertex must lie within TP_ORIGIN_FACTOR × the scene's bounding-box diagonal
# of the origin (relative error in t scales like (dist/diag) · 2⁻²⁴ ≈ 1e-7 ·
# dist/diag; 64 keeps it ≤ ~1e-5, comfortably inside the allclose contract).
TP_ORIGIN_FACTOR = 64.0

# tp table layout (T, 24) f32 — columns:
#  0:3 N | 3:6 e1 | 6:9 e2 | 9:12 C1 | 12:15 C2 | 15 k |
#  16 code = material class index + 1 (0 = "no hit") | 17:24 pad


def material_classes(scene: Scene):
    """Deduplicate materials into (albedo, emissive, roughness, mtype) classes.

    Returns (classes, per-material class index). The reference's Cornell scene
    has 18 material records but only 5 distinct classes (white/red/green
    diffuse, gold specular, light — RaytraceTest.cpp:145-176)."""
    m = scene.materials
    alb = np.asarray(m.albedo, np.float32)
    emi = np.asarray(m.emissive, np.float32)
    rough = np.asarray(m.roughness, np.float32)
    mty = np.asarray(m.mtype, np.float32)
    seen: dict = {}
    classes = []
    idx = np.zeros(alb.shape[0], np.int32)
    for i in range(alb.shape[0]):
        key = (tuple(alb[i].tolist()), tuple(emi[i].tolist()),
               float(rough[i]), float(mty[i]))
        if key not in seen:
            seen[key] = len(classes)
            classes.append(key)
        idx[i] = seen[key]
    return tuple(classes), idx


def tp_scan_supported(scene: Scene) -> bool:
    """True if the scene's materials dedupe to ≤ TP_CLASS_CAP classes with
    diffuse/specular mtypes, AND the geometry sits near the world origin
    (every vertex within TP_ORIGIN_FACTOR × bbox diagonal — see the
    TP_ORIGIN_FACTOR comment; far-from-origin scenes cancel catastrophically
    in the tp forms and must use parity/fast). Unlike fast_scan_supported
    there is NO shared-emitter or roughness-range restriction — each class
    carries its own full attribute tuple as baked constants."""
    classes, _ = material_classes(scene)
    mty = np.asarray(scene.materials.mtype)
    if not (len(classes) <= TP_CLASS_CAP
            and np.all((mty == 1) | (mty == 2))):
        return False
    g = scene.geometry
    verts = np.concatenate([np.asarray(g.p1, np.float64),
                            np.asarray(g.p2, np.float64),
                            np.asarray(g.p3, np.float64)])
    if verts.shape[0] == 0:
        return True
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    dist = float(np.linalg.norm(verts, axis=-1).max())
    return dist <= TP_ORIGIN_FACTOR * max(diag, 1e-12)


def pack_scene_tp(scene: Scene):
    """Pack the scene for the tp scan: ((T, 24) table, static class tuple)."""
    g = scene.geometry
    p1 = np.asarray(g.p1, np.float32)
    e1 = np.asarray(g.p2, np.float32) - p1
    e2 = np.asarray(g.p3, np.float32) - p1
    nrm = np.cross(e2, e1)
    classes, cls_of_mat = material_classes(scene)
    mid = np.asarray(g.mat_id)
    tbl = np.zeros((p1.shape[0], TABLE_COLS), np.float32)
    tbl[:, 0:3] = nrm
    tbl[:, 3:6] = e1
    tbl[:, 6:9] = e2
    tbl[:, 9:12] = np.cross(e2, p1)
    tbl[:, 12:15] = np.cross(e1, p1)
    tbl[:, 15] = np.einsum("ij,ij->i", p1, nrm)
    tbl[:, 16] = (cls_of_mat[mid] + 1).astype(np.float32)
    return jnp.asarray(tbl), classes


def flat_table(table: jnp.ndarray) -> jnp.ndarray:
    """(T, C) table → 1-D, zero-padded to a power-of-two length (Triton's
    block sizes). Only rows < T are ever read, so the padding is inert."""
    flat = table.reshape(-1)
    n = int(flat.shape[0])
    return jnp.pad(flat, (0, pl.next_power_of_2(max(n, 1)) - n))


# ---- component-wise 3-vector helpers over lane vectors -----------------------

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _neg3(a):
    return (-a[0], -a[1], -a[2])


def _where3(c, a, b):
    return (jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1]),
            jnp.where(c, a[2], b[2]))


def _normalize3(a):
    inv = jax.lax.rsqrt(jnp.maximum(_dot3(a, a), 1e-40))
    return _scale3(a, inv)


def _safe_denom(x, eps=1e-8):
    return jnp.where(jnp.abs(x) > eps, x, jnp.where(x >= 0.0, eps, -eps))


def _camera_constants(cfg: RenderConfig):
    """Host-side camera basis (≡ core/camera.basis) baked into the kernel."""
    look = np.asarray(cfg.camera.look, np.float64)
    up = np.asarray(cfg.camera.up, np.float64)
    view = look / np.linalg.norm(look)
    hol = np.cross(view, up)
    hol = hol / np.linalg.norm(hol)
    upd = np.cross(hol, view)
    upd = upd / np.linalg.norm(upd)
    angle = math.tan(0.5 * math.radians(cfg.camera.vfov_degrees))
    return (tuple(np.float32(v) for v in view), tuple(np.float32(v) for v in hol),
            tuple(np.float32(v) for v in upd), np.float32(angle),
            tuple(np.float32(v) for v in cfg.camera.eye))


def camera_path(cfg: RenderConfig, pid, sample_idx):
    """Seed + camera ray (generateRay, GenerateColors.cl:263-288) for one
    progressive frame; returns the path state (o, d, mask, rad, active, rng).
    `active` is an f32 0/1 lane mask."""
    view, hol, upd, angle, eye = _camera_constants(cfg)
    W, H = cfg.width, cfg.height
    aspect = np.float32(W / H)
    state = krng.seed_from(pid, sample_idx)
    state, u1 = krng.next_float(state)
    state, u2 = krng.next_float(state)
    x = (pid % W).astype(jnp.float32) + u1 - 0.5
    y = (pid // W).astype(jnp.float32) + u2 - 0.5
    sx = (2.0 * ((x + 0.5) * (1.0 / W)) - 1.0) * angle * aspect
    sy = -(1.0 - 2.0 * ((y + 0.5) * (1.0 / H))) * angle
    d = _normalize3((sx * hol[0] - sy * upd[0] + view[0],
                     sx * hol[1] - sy * upd[1] + view[1],
                     sx * hol[2] - sy * upd[2] + view[2]))
    zeros = jnp.zeros_like(sx)
    ones = zeros + 1.0
    o = (zeros + eye[0], zeros + eye[1], zeros + eye[2])
    return (o, d, (ones, ones, ones), (zeros, zeros, zeros), ones, state)


def shade(cfg: RenderConfig, path, hit):
    """The post-scan part of one bounce (GenerateColors.cl:227-258).

    hit = (best_t, normal, albedo, emissive, rough, mtype) of the nearest hit.
    Returns (path', terms) with terms = (active, miss, q, qf, alive): the
    lanes that hit an active path, the active lanes that missed, the BRDF
    weight per unit albedo q (f = albedo·q — diffuse 1/π, GGX D/(4 cosi coso)·2)
    and q·cosθ/pdf — what the adjoint kernel needs beyond the forward."""
    o, d, mask, rad, active_f, state = path
    best_t, bn, balb, bemi, brough, bmty = hit
    bg = tuple(np.float32(c) for c in cfg.bg_color)
    eboost = np.float32(cfg.emissive_boost)
    active = active_f > 0.5
    hit_any = best_t < T_MAX

    # ---- miss: masked bg once, lane dies (GenerateColors.cl:233-237)
    miss = active & ~hit_any
    rad = (rad[0] + jnp.where(miss, mask[0] * bg[0], 0.0),
           rad[1] + jnp.where(miss, mask[1] * bg[1], 0.0),
           rad[2] + jnp.where(miss, mask[2] * bg[2], 0.0))
    active = active & hit_any

    # ---- emission ×3 (GenerateColors.cl:241)
    rad = (rad[0] + jnp.where(active, mask[0] * bemi[0] * eboost, 0.0),
           rad[1] + jnp.where(active, mask[1] * bemi[1] * eboost, 0.0),
           rad[2] + jnp.where(active, mask[2] * bemi[2] * eboost, 0.0))

    # ---- flip normal against ray (GenerateColors.cl:243)
    n = _where3(_dot3(bn, d) < 0.0, bn, _neg3(bn))
    wo = _neg3(d)

    # ---- draws: phi then xi (GenerateColors.cl:163-164 / 182-183)
    state, ud1 = krng.next_float(state)
    state, ud2 = krng.next_float(state)

    # tangent frame (GenerateColors.cl:167-169)
    zeros = jnp.zeros_like(ud1)
    ones = zeros + 1.0
    use_y = jnp.abs(n[0]) > 0.001
    axis = _where3(use_y, (zeros, ones, zeros), (ones, zeros, zeros))
    tt = _normalize3(_cross3(axis, n))
    ss = _cross3(n, tt)

    phi = TWO_PI * ud1
    cphi = jnp.cos(phi)
    sphi = jnp.sin(phi)

    # diffuse lobe (GenerateColors.cl:161-172, 197-204): f = albedo/π
    sin_d = jnp.sqrt(ud2)
    cos_d = jnp.sqrt(1.0 - ud2)
    wi_d = _normalize3(_add3(_add3(
        _scale3(ss, cphi * sin_d), _scale3(tt, sphi * sin_d)),
        _scale3(n, cos_d)))
    pdf_d = _dot3(wi_d, n) * INV_PI

    # specular GGX lobe (GenerateColors.cl:174-192, 205-218)
    r2 = brough * brough
    cos_h = jnp.sqrt(
        (1.0 - ud2) / jnp.maximum(ud2 * (r2 - 1.0) + 1.0, 1e-12))
    sin_h = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_h * cos_h))
    wh = _normalize3(_add3(_add3(
        _scale3(ss, cphi * sin_h), _scale3(tt, sphi * sin_h)),
        _scale3(n, cos_h)))
    wi_s = _add3(_neg3(wo), _scale3(wh, 2.0 * _dot3(wo, wh)))
    same_hemi = _dot3(wi_s, n) * _dot3(wo, n) >= 0.0
    denom_ndf = cos_h * cos_h * (r2 - 1.0) + 1.0
    # max clamp: r=0 (diffuse lanes) makes this 0/0 otherwise.
    d_ndf = r2 * INV_PI / jnp.maximum(denom_ndf * denom_ndf, 1e-12)
    pdf_s = d_ndf * cos_h / _safe_denom(4.0 * _dot3(wo, wh))
    fs_scalar = d_ndf / _safe_denom(
        4.0 * _dot3(wi_s, n) * _dot3(wo, n)) * 2.0  # ×2 quirk :217
    pdf_s = jnp.where(same_hemi, pdf_s, 0.0)
    q_s = jnp.where(same_hemi, fs_scalar, 0.0)

    bspec = bmty >= 1.5
    wi = _where3(bspec, wi_s, wi_d)
    pdf = jnp.where(bspec, pdf_s, pdf_d)
    q = jnp.where(bspec, q_s, INV_PI)

    # pdf <= 0 terminates (GenerateColors.cl:251)
    alive = active & (pdf > 0.0)
    safe_pdf = jnp.where(pdf > 0.0, pdf, 1.0)
    factor = _dot3(wi, n) / safe_pdf
    f = _scale3(balb, q)
    mask_out = (jnp.where(alive, mask[0] * f[0] * factor, mask[0]),
                jnp.where(alive, mask[1] * f[1] * factor, mask[1]),
                jnp.where(alive, mask[2] * f[2] * factor, mask[2]))

    # re-spawn offset 0.01 along wi (GenerateColors.cl:257)
    hitp = _add3(o, _scale3(d, best_t))
    o = _add3(hitp, _scale3(wi, np.float32(cfg.ray_offset)))
    d = _where3(alive, wi, d)
    path = (o, d, mask_out, rad, jnp.where(alive, 1.0, 0.0), state)
    return path, (active, miss, q, q * factor, alive)


def tri_tp(tl, j, o, d, m, tc):
    """One triangle of the triple-product scan (tp table layout): the fast
    scan's division-free order/validity tests on tp-computed numerators.
    tc = (t_num, t_den, raw N, class code); m = cross(o, d)."""
    nv = (tl(j, 0), tl(j, 1), tl(j, 2))
    e1 = (tl(j, 3), tl(j, 4), tl(j, 5))
    e2 = (tl(j, 6), tl(j, 7), tl(j, 8))
    c1 = (tl(j, 9), tl(j, 10), tl(j, 11))
    c2 = (tl(j, 12), tl(j, 13), tl(j, 14))
    kk = tl(j, 15)
    code = tl(j, 16)
    bnum, bden, bN, bcode = tc
    det = _dot3(d, nv)
    tnum = kk - _dot3(o, nv)
    unum = _dot3(e2, m) - _dot3(d, c1)
    vnum = _dot3(d, c2) - _dot3(e1, m)
    inside = jnp.minimum(jnp.minimum(unum, vnum), det - (unum + vnum)) >= 0.0
    sel = ((det >= 1e-8)  # backface cull (GenerateColors.cl:100)
           & inside & (tnum > 0.0) & (tnum * bden < bnum * det))
    return (jnp.where(sel, tnum, bnum), jnp.where(sel, det, bden),
            _where3(sel, nv, bN), jnp.where(sel, code, bcode))


def tp_fresh(zeros):
    """Empty tp best hit: t = T_MAX/1 (decodes to exactly T_MAX), code 0."""
    return (zeros + T_MAX, zeros + 1.0, (zeros, zeros, zeros), zeros)


def decode_tp_tc(tc, classes):
    """Decode the tp scan's tracked channels to the parity best-hit tuple.

    (t_num, t_den, N×3, class code) → (best_t, normal, albedo, emissive,
    rough, mtype). Runs once per bounce: one divide, one 1/sqrt normalize of
    the winner's raw N, and an unrolled select chain over the ≤TP_CLASS_CAP
    material classes. `classes` holds (albedo, emissive, rough, mtype) per
    class as Python floats or as scalars loaded from a table. No-hit lanes
    decode to best_t == T_MAX exactly."""
    bnum, bden, bN, bcode = tc
    best_t = bnum / bden
    inv = 1.0 / jnp.sqrt(jnp.maximum(_dot3(bN, bN), 1e-40))
    bn = _scale3(bN, inv)
    zeros = jnp.zeros_like(bnum)
    balb = bemi = (zeros, zeros, zeros)
    brough = zeros
    bmty = zeros + 1.0  # diffuse default; no-hit lanes are inactive anyway
    for i, (alb, emi, rough, mty) in enumerate(classes):
        sel = jnp.abs(bcode - (i + 1.0)) < 0.5
        balb = _where3(sel, alb, balb)
        bemi = _where3(sel, emi, bemi)
        brough = jnp.where(sel, rough, brough)
        bmty = jnp.where(sel, mty, bmty)
    return best_t, bn, balb, bemi, brough, bmty


def decode_fast_tc(tc, emi_const):
    """Decode the fast scan's tracked channels to the parity best-hit tuple.

    (t_num, t_den, normal, albedo, code) → (best_t, normal, albedo, emissive,
    rough, mtype). Runs once per bounce — it amortizes the per-triangle divide
    and attribute selects the fast scan removed. No-hit lanes decode to
    best_t == T_MAX exactly (t_num init T_MAX / t_den init 1), so the standard
    `best_t < T_MAX` hit test is unchanged."""
    bnum, bden, bn, balb, bcode = tc
    best_t = bnum / bden            # the one divide
    emit = bcode >= 15.5
    code2 = bcode - jnp.where(emit, 16.0, 0.0)
    bspec = code2 >= 7.5
    brough = jnp.maximum(code2 - jnp.where(bspec, 8.0, 4.0), 0.0)
    bmty = jnp.where(bspec, 2.0, 1.0)
    emit_f = jnp.where(emit, 1.0, 0.0)
    bemi = (emit_f * emi_const[0], emit_f * emi_const[1],
            emit_f * emi_const[2])
    return best_t, bn, balb, bemi, brough, bmty


def _make_kernel(cfg: RenderConfig, n_tris: int, n_samples: int,
                 scan: str = "parity", emi_const: tuple = (0.0, 0.0, 0.0),
                 classes: tuple = (), rays_input: bool = False):
    """Build the kernel body with all static config baked in.

    scan: "parity" reproduces the reference's intersectTriangle arithmetic
    exactly (per-triangle inv_det divide, u/v in [0,1], 12 tracked best-hit
    channels — comparable with integrators/parity.py). "fast" is the
    division-free form: candidate t stays a (num, den) fraction compared by
    cross-multiplication (den > 0 after the backface cull), u/v tests run on
    the undivided numerators, and the best hit tracks 9 channels
    (t_num, t_den, normal×3, albedo×3, fused rough/mtype/is-emitter code)
    instead of 12, decoded once per bounce; the shared emitter RGB arrives as
    the static `emi_const` (scene_emissive_const). Hit DECISIONS can differ
    from parity only where the reference's u = unum*(1/det) rounds across a
    comparison boundary; images are allclose. Requires
    fast_scan_supported(scene).

    "tp" is the triple-product scan (see the block comment above
    material_classes): precomputed per-triangle constants drop the two
    in-scan cross products and the tracked state shrinks to 6 channels;
    material attributes arrive via the static `classes` tuple
    (pack_scene_tp's second return). The table MUST be pack_scene_tp's.
    Requires tp_scan_supported(scene); same allclose-to-parity contract as
    "fast".

    rays_input: origins and directions arrive as (4, BLOCK) planes (x, y, z,
    pad) instead of the camera prologue — the radiance-probe entry
    (trace_rays_pallas_stats)."""
    if scan not in ("parity", "fast", "tp"):
        raise ValueError(f"scan must be 'parity', 'fast' or 'tp', got {scan!r}")
    if scan == "tp" and not classes:
        raise ValueError("scan='tp' needs the classes tuple from pack_scene_tp")

    def kernel(table_ref, scal_ref, *rest):
        if rays_input:
            o_ref, d_ref, out_ref = rest
        else:
            (out_ref,) = rest

        def tl(j, c):
            return table_ref[j * TABLE_COLS + c]

        # scal_ref = (first sample, ABSOLUTE pixel/row id of this call's
        # first lane) — nonzero when the image is shard_map-split across
        # devices. Keying the RNG on the absolute id is what makes sharded
        # output bitwise layout-invariant.
        pid = lane_ids(scal_ref[1])
        zeros = jnp.zeros((BLOCK,), jnp.float32)

        def start_path(sample_idx):
            if not rays_input:
                return camera_path(cfg, pid, sample_idx)
            # Arbitrary rays: no camera, no jitter draws — the stream's first
            # two draws are bounce 0's (phi, xi), matching the jnp twin
            # ref_uniforms(row_ids, sample, 2*bounces). Two calls with equal
            # row counts share their streams row for row (the CRN pairing).
            ones = zeros + 1.0
            o = (o_ref[0, :], o_ref[1, :], o_ref[2, :])
            d = (d_ref[0, :], d_ref[1, :], d_ref[2, :])
            return (o, d, (ones, ones, ones), (zeros, zeros, zeros), ones,
                    krng.seed_from(pid, sample_idx))

        def scan_hits(o, d):
            """Nearest-hit scan (in-order, strict '<' ≡ reference
            intersectWorld, GenerateColors.cl:137-154; winning attributes
            tracked incrementally — no gather), decoded to the parity
            best-hit tuple."""
            if scan == "tp":
                m = _cross3(o, d)
                tc = jax.lax.fori_loop(
                    0, n_tris, lambda j, tc: tri_tp(tl, j, o, d, m, tc),
                    tp_fresh(zeros))
                return decode_tp_tc(tc, classes)
            if scan == "fast":
                tc = jax.lax.fori_loop(
                    0, n_tris, lambda j, tc: _tri_fast(tl, j, o, d, tc),
                    (zeros + T_MAX, zeros + 1.0, (zeros, zeros, zeros),
                     (zeros, zeros, zeros), zeros))
                return decode_fast_tc(tc, emi_const)
            return jax.lax.fori_loop(
                0, n_tris, lambda j, tc: _tri_parity(tl, j, o, d, tc),
                (zeros + T_MAX, (zeros, zeros, zeros), (zeros, zeros, zeros),
                 (zeros, zeros, zeros), zeros, zeros))

        # One path per lane per sample. The bounce loop exits as soon as every
        # lane of the block is dead: skipped bounces contribute nothing, so
        # the image and the segment count equal the fixed-depth loop's.
        def bounce_cond(carry):
            b, path, _ = carry
            return (b < cfg.bounces) & (jnp.max(path[4]) > 0.5)

        def bounce_body(carry):
            b, path, sg = carry
            sg = sg + path[4]  # segments traced this bounce = lanes alive
            path, _ = shade(cfg, path, scan_hits(path[0], path[1]))
            return b + 1, path, sg

        def sample_body(s, acc):
            r0, g0, b0, sg = acc
            _, path, sg = jax.lax.while_loop(
                bounce_cond, bounce_body,
                (jnp.int32(0), start_path(scal_ref[0] + s), sg))
            rad = path[3]
            # max(radiance, 0) — GenerateColors.cl:260
            return (r0 + jnp.maximum(rad[0], 0.0),
                    g0 + jnp.maximum(rad[1], 0.0),
                    b0 + jnp.maximum(rad[2], 0.0), sg)

        acc = jax.lax.fori_loop(0, n_samples, sample_body,
                                (zeros, zeros, zeros, zeros))
        for c in range(4):
            out_ref[c, :] = acc[c]

    return kernel


def _tri_parity(tl, j, o, d, tc):
    """One triangle of the reference-exact scan (intersectTriangle,
    GenerateColors.cl:90-130): per-triangle inv_det divide, 12 channels."""
    p1 = (tl(j, 0), tl(j, 1), tl(j, 2))
    e1 = (tl(j, 3), tl(j, 4), tl(j, 5))
    e2 = (tl(j, 6), tl(j, 7), tl(j, 8))
    nrm = (tl(j, 9), tl(j, 10), tl(j, 11))
    alb = (tl(j, 12), tl(j, 13), tl(j, 14))
    emi = (tl(j, 15), tl(j, 16), tl(j, 17))
    best_t, bn, balb, bemi, brough, bmty = tc
    pvec = _cross3(d, e2)
    det = _dot3(e1, pvec)
    front = det >= 1e-8  # backface cull (GenerateColors.cl:100)
    inv_det = 1.0 / jnp.where(front, det, 1.0)
    tvec = (o[0] - p1[0], o[1] - p1[1], o[2] - p1[2])
    u = _dot3(tvec, pvec) * inv_det
    qvec = _cross3(tvec, e1)
    v = _dot3(d, qvec) * inv_det
    t = _dot3(e2, qvec) * inv_det
    sel = (front & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 0.0) & (t < best_t))
    return (jnp.where(sel, t, best_t), _where3(sel, nrm, bn),
            _where3(sel, alb, balb), _where3(sel, emi, bemi),
            jnp.where(sel, tl(j, 18), brough), jnp.where(sel, tl(j, 19), bmty))


def _tri_fast(tl, j, o, d, tc):
    """One triangle of the division-free scan (see _make_kernel): candidate
    t = t_num/det is never divided — ordering uses t_num*best_den <
    best_num*det (both dens > 0 by the backface cull); u,v tests run as
    0 <= u_num, 0 <= v_num, u_num+v_num <= det (u <= 1 is implied)."""
    p1 = (tl(j, 0), tl(j, 1), tl(j, 2))
    e1 = (tl(j, 3), tl(j, 4), tl(j, 5))
    e2 = (tl(j, 6), tl(j, 7), tl(j, 8))
    nrm = (tl(j, 9), tl(j, 10), tl(j, 11))
    alb = (tl(j, 12), tl(j, 13), tl(j, 14))
    bnum, bden, bn, balb, bcode = tc
    pvec = _cross3(d, e2)
    det = _dot3(e1, pvec)
    tvec = (o[0] - p1[0], o[1] - p1[1], o[2] - p1[2])
    unum = _dot3(tvec, pvec)
    qvec = _cross3(tvec, e1)
    vnum = _dot3(d, qvec)
    tnum = _dot3(e2, qvec)
    inside = jnp.minimum(jnp.minimum(unum, vnum), det - (unum + vnum)) >= 0.0
    sel = ((det >= 1e-8)  # backface cull (GenerateColors.cl:100)
           & inside & (tnum > 0.0) & (tnum * bden < bnum * det))
    return (jnp.where(sel, tnum, bnum), jnp.where(sel, det, bden),
            _where3(sel, nrm, bn), _where3(sel, alb, balb),
            jnp.where(sel, tl(j, 23), bcode))


def lane_planes(x: jnp.ndarray, n_pad: int) -> jnp.ndarray:
    """(n, 3) → (4, n_pad) planes (x, y, z, 0): the kernels' per-lane input
    layout — each row is read as one contiguous lane vector."""
    out = jnp.zeros((4, n_pad), jnp.float32)
    return out.at[:3, :x.shape[0]].set(jnp.asarray(x, jnp.float32).T)


def call_kernel(kernel, whole, planes, n_pad: int, extra_out=None):
    """pallas_call over n_pad / BLOCK programs. Inputs: `whole` arrays that
    every program reads entirely (tables, the (2,) int32 scalars), then
    (4, n_pad) lane planes; output (4, n_pad) — plus `extra_out` =
    (block_shape, index_map, shape) for a second output."""
    plane = pl.BlockSpec((4, BLOCK), lambda i: (0, i))
    out_specs = plane
    out_shape = jax.ShapeDtypeStruct((4, n_pad), jnp.float32)
    if extra_out is not None:
        bs, im, shape = extra_out
        out_specs = (plane, pl.BlockSpec(bs, im))
        out_shape = (out_shape, jax.ShapeDtypeStruct(shape, jnp.float32))
    return pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        in_specs=[pl.BlockSpec()] * len(whole) + [plane] * len(planes),
        out_specs=out_specs,
        out_shape=out_shape,
        **pallas_params(NUM_WARPS),
    )(*whole, *planes)


def lane_ids(base):
    """Inside a kernel: the ABSOLUTE pixel/row id of each lane of this
    program's block, from the id of the call's first lane."""
    return (base + pl.program_id(0) * BLOCK
            + jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0))


def _scalars(start_sample, base):
    return jnp.stack([jnp.asarray(start_sample, jnp.int32),
                      jnp.asarray(base, jnp.int32)])


@functools.partial(jax.jit,
                   static_argnames=("cfg", "n_samples", "n_rays", "scan",
                                    "emi_const", "classes"))
def render_samples_pallas_stats(table: jnp.ndarray, cfg: RenderConfig,
                                start_sample, n_samples: int,
                                pid_base=0, n_rays: int | None = None,
                                scan: str = "parity",
                                emi_const: tuple = (0.0, 0.0, 0.0),
                                classes: tuple = ()):
    """SUM of `n_samples` progressive 1-spp frames + traced-segment count.

    Returns (img (n_rays, 3) f32, segments () f32). `table` is pack_scene(scene)
    (pack_scene_tp for scan="tp"); `start_sample` the first frame index;
    streams are the reference's, keyed (ABSOLUTE pixel, frame). Padded lanes
    (pixel id ≥ n_pixels) are excluded from the segment count.

    `pid_base`/`n_rays` support shard_map tiling: a device rendering pixels
    [pid_base, pid_base + n_rays) passes its offset so RNG/camera stay keyed on
    absolute ids (bitwise layout invariance).
    """
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    n_pad = pl.cdiv(n_pix, BLOCK) * BLOCK
    kernel = _make_kernel(cfg, int(table.shape[0]), n_samples, scan=scan,
                          emi_const=emi_const, classes=classes)
    out = call_kernel(kernel, (flat_table(table),
                               _scalars(start_sample, pid_base)), (), n_pad)
    return out[:3, :n_pix].T, jnp.sum(out[3, :n_pix])


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples", "scan",
                                             "emi_const", "classes"))
def render_samples_pallas(table: jnp.ndarray, cfg: RenderConfig,
                          start_sample, n_samples: int, scan: str = "parity",
                          emi_const: tuple = (0.0, 0.0, 0.0),
                          classes: tuple = ()) -> jnp.ndarray:
    """SUM of `n_samples` progressive 1-spp frames: (n_pixels, 3) f32."""
    img, _ = render_samples_pallas_stats(table, cfg, start_sample, n_samples,
                                         scan=scan, emi_const=emi_const,
                                         classes=classes)
    return img


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples", "scan",
                                             "emi_const", "classes"))
def trace_rays_pallas_stats(table: jnp.ndarray, o: jnp.ndarray,
                            d: jnp.ndarray, cfg: RenderConfig,
                            n_samples: int, row_base=0, start_sample=0,
                            scan: str = "parity",
                            emi_const: tuple = (0.0, 0.0, 0.0),
                            classes: tuple = ()):
    """SUM of `n_samples` CRN path traces along ARBITRARY rays (o, d) (N, 3).

    The camera prologue is replaced by ray inputs (rays_input mode of
    _make_kernel) — the kernel-speed radiance-probe entry the boundary
    estimators batch their L_in/L_out evaluations through. Streams key on
    (row_base + row index, sample): two calls with equal row counts and the
    same row_base share streams row-for-row, the CRN contract the ± rim probes
    rely on. Returns (radiance_sum (N, 3), segments). jnp twin: trace_paths
    with ref_uniforms(row_ids, sample, 2*cfg.bounces).
    `cfg.width/height` are ignored (no camera); bounces/bg/boost/offset apply.
    """
    n = int(o.shape[0])
    n_pad = pl.cdiv(n, BLOCK) * BLOCK
    # Padded rows trace a unit ray and are sliced off below.
    d_planes = lane_planes(d, n_pad).at[2, n:].set(1.0)
    kernel = _make_kernel(cfg, int(table.shape[0]), n_samples, scan=scan,
                          emi_const=emi_const, classes=classes,
                          rays_input=True)
    out = call_kernel(kernel, (flat_table(table),
                               _scalars(start_sample, row_base)),
                      (lane_planes(o, n_pad), d_planes), n_pad)
    return out[:3, :n].T, jnp.sum(out[3, :n])


def resolve_scan(scene: Scene, requested: str = "auto") -> str:
    """'auto' = the fastest scan the scene's materials support: the
    triple-product tp scan (tp_scan_supported — ≤16 material classes), else
    the division-free fast scan (fast_scan_supported), else the
    reference-exact parity scan. Explicit 'parity'/'fast'/'tp' pass through."""
    if requested != "auto":
        return requested
    if tp_scan_supported(scene):
        return "tp"
    if fast_scan_supported(scene):
        return "fast"
    return "parity"


def prepare_scan(scene: Scene, requested: str = "auto"):
    """Resolve the scan mode and build its packed table + static constants.

    Returns (scan, table, emi_const, classes) — exactly the kwargs the kernel
    entry points take. The table layout depends on the scan (pack_scene_tp for
    'tp', pack_scene otherwise), so always pack through here when the scan is
    not fixed ahead of time.

    An EXPLICITLY requested 'tp'/'fast' is validated against its support
    predicate and raises ValueError on a scene it can't encode (a silent
    render would be wrong: tp's class table / fast's baked emitter constant
    would mis-shade). 'auto' never raises — it only picks supported scans."""
    scan = resolve_scan(scene, requested)
    if scan == "tp":
        if requested == "tp" and not tp_scan_supported(scene):
            raise ValueError(
                "scan='tp' requested but tp_scan_supported(scene) is False "
                f"(> {TP_CLASS_CAP} material classes, non-diffuse/specular "
                "mtype, or geometry too far from the origin — see "
                "TP_ORIGIN_FACTOR); use scan='auto' to fall back")
        table, classes = pack_scene_tp(scene)
        return scan, table, (0.0, 0.0, 0.0), classes
    if scan == "fast" and requested == "fast" and not fast_scan_supported(scene):
        raise ValueError(
            "scan='fast' requested but fast_scan_supported(scene) is False "
            "(emitters with differing RGBs, roughness >= 4, or mtype not "
            "diffuse/specular); use scan='auto' to fall back")
    table = pack_scene(scene)
    emi = scene_emissive_const(scene) if scan == "fast" else (0.0, 0.0, 0.0)
    return scan, table, emi, ()


def render_pallas(scene: Scene, cfg: RenderConfig, total_spp: int,
                  samples_per_call: int = 0,
                  scan: str = "auto") -> jnp.ndarray:
    """Progressive mean image via the megakernel (host loop over sample chunks)."""
    scan, table, emi, classes = prepare_scan(scene, scan)
    chunk = samples_per_call or total_spp
    acc = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    s = 0
    while s < total_spp:
        n = min(chunk, total_spp - s)
        acc = acc + render_samples_pallas(table, cfg, s, n, scan=scan,
                                          emi_const=emi, classes=classes)
        s += n
    return acc / total_spp
