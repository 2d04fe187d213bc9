"""BRDF sampling and evaluation — cosine-weighted diffuse + GGX specular.

Reproduces the reference's shading math (Brdf, GenerateColors.cl:195-221) including
the quirks SURVEY.md §2.2 flags for parity:

  * the GGX weight carries an extra ×2.0 factor (GenerateColors.cl:217);
  * a specular sample below the horizon (wi·n · wo·n < 0) returns f=0 with pdf left
    at 0 → the caller terminates the path (GenerateColors.cl:211 + :251);
  * the tangent frame picks axis (0,1,0) when |n.x| > 0.001 else (1,0,0)
    (GenerateColors.cl:167, :187).

Branch-free: both lobes are evaluated and selected by material type — required
under vmap/jit anyway, and it keeps the kernels' lanes in step.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from oclpathtracer_tpu.scene.types import SPECULAR

INV_PI = 0.31830988618  # GenerateColors.cl:10
TWO_PI = 6.28318530718  # GenerateColors.cl:9


class BrdfSample(NamedTuple):
    wi: jnp.ndarray   # (N, 3) sampled incoming direction
    pdf: jnp.ndarray  # (N,)
    f: jnp.ndarray    # (N, 3) BRDF value (reference returns float4; rgb here)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _normalize(v, eps=1e-20):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def _safe_denom(x, eps=1e-8):
    """Sign-preserving clamp away from 0.

    Division by an unclamped near-zero denominator makes the UNSELECTED branch of a
    downstream jnp.where inf, and reverse-mode then produces 0·inf = NaN gradients
    even though the forward value is fine (the double-where problem). Forward change
    is confined to degenerate lanes where the reference emits inf fireflies anyway.
    """
    return jnp.where(jnp.abs(x) > eps, x, jnp.where(x >= 0.0, eps, -eps))


def tangent_frame(n: jnp.ndarray):
    """(s, t) completing n to a frame — GenerateColors.cl:167-169 axis selection."""
    use_y = jnp.abs(n[..., 0]) > 0.001
    axis = jnp.where(
        use_y[..., None],
        jnp.array([0.0, 1.0, 0.0], jnp.float32),
        jnp.array([1.0, 0.0, 0.0], jnp.float32),
    )
    t = _normalize(jnp.cross(axis, n))
    s = jnp.cross(n, t)
    return s, t


def _spherical_dir(s, t, n, phi, sin_theta, cos_theta):
    """normalize(s cosφ sinθ + t sinφ sinθ + n cosθ) — the reference's ONB compose."""
    d = (
        s * (jnp.cos(phi) * sin_theta)[..., None]
        + t * (jnp.sin(phi) * sin_theta)[..., None]
        + n * cos_theta[..., None]
    )
    return _normalize(d)


def sample_hemisphere_cosine(n: jnp.ndarray, u1, u2):
    """Cosine-weighted hemisphere sample — GenerateColors.cl:161-172."""
    phi = TWO_PI * u1
    sin_theta_sqr = u2
    sin_theta = jnp.sqrt(sin_theta_sqr)
    cos_theta = jnp.sqrt(1.0 - sin_theta_sqr)
    s, t = tangent_frame(n)
    return _spherical_dir(s, t, n, phi, sin_theta, cos_theta)


def distribution_ggx(cos_theta, roughness):
    """GGX NDF — GenerateColors.cl:174-178.

    The denominator clamp matters: at roughness=0 (every diffuse material) and
    cos_theta=1 the raw expression is 0/0 = NaN. The NaN sits in the UNSELECTED
    branch of the diffuse/specular jnp.where, so the forward pass is fine but
    reverse-mode turns it into NaN gradients for every parameter (0·NaN). With the
    clamp the r=0 case evaluates to 0 — the correct limit."""
    r2 = roughness * roughness
    denom = cos_theta * cos_theta * (r2 - 1.0) + 1.0
    return r2 * INV_PI / jnp.maximum(denom * denom, 1e-12)


def sample_ggx(n: jnp.ndarray, roughness, u1, u2):
    """GGX half-vector sample — GenerateColors.cl:180-192. Returns (wh, cos_theta)."""
    phi = TWO_PI * u1
    xi = u2
    cos_theta = jnp.sqrt(
        (1.0 - xi) / jnp.maximum(xi * (roughness * roughness - 1.0) + 1.0, 1e-12)
    )
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    s, t = tangent_frame(n)
    return _spherical_dir(s, t, n, phi, sin_theta, cos_theta), cos_theta


def reflect(v: jnp.ndarray, n: jnp.ndarray):
    """-v + 2(v·n)n — GenerateColors.cl:156-159 (v points AWAY from the surface)."""
    return -v + 2.0 * _dot(v, n)[..., None] * n


def sample_brdf(wo: jnp.ndarray, n: jnp.ndarray, albedo: jnp.ndarray,
                roughness: jnp.ndarray, mtype: jnp.ndarray,
                u1: jnp.ndarray, u2: jnp.ndarray) -> BrdfSample:
    """Sample wi and evaluate (f, pdf) for a ray batch.

    wo: (N, 3) outgoing (toward camera/previous vertex), n: (N, 3) shading normal
    already flipped against the incident ray, albedo: (N, 3), roughness/mtype: (N,).
    """
    # ---- diffuse lobe (GenerateColors.cl:197-204)
    wi_d = sample_hemisphere_cosine(n, u1, u2)
    pdf_d = _dot(wi_d, n) * INV_PI
    f_d = albedo * INV_PI

    # ---- specular GGX lobe (GenerateColors.cl:205-218)
    wh, cos_theta = sample_ggx(n, roughness, u1, u2)
    wi_s = reflect(wo, wh)
    same_hemisphere = _dot(wi_s, n) * _dot(wo, n) >= 0.0
    d_ndf = distribution_ggx(cos_theta, roughness)
    denom_pdf = _safe_denom(4.0 * _dot(wo, wh))
    pdf_s_raw = d_ndf * cos_theta / denom_pdf
    denom_f = _safe_denom(4.0 * _dot(wi_s, n) * _dot(wo, n))
    f_s_raw = (d_ndf / denom_f)[..., None] * albedo * 2.0  # ×2 quirk, :217
    pdf_s = jnp.where(same_hemisphere, pdf_s_raw, 0.0)
    f_s = jnp.where(same_hemisphere[..., None], f_s_raw, 0.0)

    is_spec = mtype == SPECULAR
    wi = jnp.where(is_spec[..., None], wi_s, wi_d)
    pdf = jnp.where(is_spec, pdf_s, pdf_d)
    f = jnp.where(is_spec[..., None], f_s, f_d)
    return BrdfSample(wi=wi, pdf=pdf, f=f)


def eval_brdf(wo: jnp.ndarray, wi: jnp.ndarray, n: jnp.ndarray, albedo: jnp.ndarray,
              roughness: jnp.ndarray, mtype: jnp.ndarray):
    """Evaluate f(wo, wi) for a GIVEN wi (used by NEE shadow rays; the reference has
    no NEE so this matches its diffuse model and treats the near-mirror GGX lobe's
    NEE contribution as negligible — standard practice for delta-ish lobes)."""
    cos_i = _dot(wi, n)
    f_d = albedo * INV_PI

    wh = _normalize(wo + wi)
    cos_h = _dot(wh, n)
    d_ndf = distribution_ggx(cos_h, roughness)
    denom = 4.0 * jnp.maximum(_dot(wi, n) * _dot(wo, n), 1e-8)
    f_s = (d_ndf / denom)[..., None] * albedo * 2.0

    is_spec = mtype == SPECULAR
    f = jnp.where(is_spec[..., None], f_s, f_d)
    return jnp.where((cos_i > 0.0)[..., None], f, 0.0)
