"""Inverse rendering: differentiable parameters + train steps (single and sharded).

The trainable subset of the scene is a small pytree (SceneParams) grafted back into
the full Scene before each forward render. Gradients flow through the integrator's
material gathers and the intersection geometry; under the tile-sharded mesh each
device differentiates its own pixel strip and parameter grads all-reduce with
jax.lax.psum, over NVLink between the cards of one host (SURVEY.md §5.8 — the
design the reference has no analogue of).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from oclpathtracer_tpu.config import RenderConfig
from oclpathtracer_tpu.core import rng
from oclpathtracer_tpu.diff.losses import l2_loss
from oclpathtracer_tpu.integrators.path import render_sample
from oclpathtracer_tpu.parallel.mesh import TILE_AXIS
from oclpathtracer_tpu.scene.types import Geometry, Materials, Scene


class SceneParams(NamedTuple):
    """Trainable leaves. Any may be None → frozen at the scene's current value."""

    albedo: Optional[jnp.ndarray] = None     # (M, 3)
    emissive: Optional[jnp.ndarray] = None   # (M, 3)
    vertices: Optional[tuple] = None         # (p1, p2, p3) each (T, 3)
    roughness: Optional[jnp.ndarray] = None  # (M,) — GGX roughness (north-star
    # "material albedo/specular"; the reference's one specular material is
    # roughness 0.008, RaytraceTest.cpp:170-172, GGX GenerateColors.cl:174-192)


def extract_params(scene: Scene, albedo=True, emissive=False,
                   vertices=False, roughness=False) -> SceneParams:
    return SceneParams(
        albedo=scene.materials.albedo if albedo else None,
        emissive=scene.materials.emissive if emissive else None,
        vertices=(scene.geometry.p1, scene.geometry.p2, scene.geometry.p3)
        if vertices else None,
        roughness=scene.materials.roughness if roughness else None,
    )


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    """Graft trainable leaves back into the scene pytree."""
    mats = scene.materials
    geom = scene.geometry
    if params.albedo is not None:
        mats = mats._replace(albedo=params.albedo)
    if params.emissive is not None:
        mats = mats._replace(emissive=params.emissive)
    if getattr(params, "roughness", None) is not None:
        mats = mats._replace(roughness=params.roughness)
    if params.vertices is not None:
        p1, p2, p3 = params.vertices
        geom = geom._replace(p1=p1, p2=p2, p3=p3)
    return scene._replace(materials=mats, geometry=geom)


def render_spp(scene: Scene, cfg: RenderConfig, spp: int, key: jax.Array,
               pixel_ids=None, base_sample: int = 0) -> jnp.ndarray:
    """Mean of `spp` 1-spp samples (scan on-device); differentiable."""
    def body(acc, s):
        radiance, _ = render_sample(scene, cfg, s, key, pixel_ids=pixel_ids)
        return acc + radiance, None

    n = cfg.n_pixels if pixel_ids is None else pixel_ids.shape[0]
    acc, _ = jax.lax.scan(
        body, jnp.zeros((n, 3), jnp.float32),
        base_sample + jnp.arange(spp, dtype=jnp.int32),
    )
    return acc / spp


def make_loss_fn(scene: Scene, cfg: RenderConfig, spp: int) -> Callable:
    """loss(params, target, key, pixel_ids) with common-random-number rendering.

    Fixing `key` fixes the full sample set, so finite differences of this loss are
    well-defined (no MC noise between the two evaluations) — the property the
    gradient-parity tests (BASELINE.json config 5) rely on.
    """

    def loss(params: SceneParams, target, key, pixel_ids=None):
        img = render_spp(apply_params(scene, params), cfg, spp, key, pixel_ids)
        n = img.shape[0]
        return l2_loss(img, target) / n

    return loss


def make_unbiased_loss_fn(scene: Scene, cfg: RenderConfig, spp: int) -> Callable:
    """Pairwise loss with unbiased value AND gradient.

    Plain MSE of a Monte-Carlo render is biased: E[(X(θ)−t)²] = (E X − t)² +
    Var X(θ), so gradient descent also minimizes estimator VARIANCE — it pushes
    bright/high-variance albedos down even when the mean image already matches.
    Rendering two INDEPENDENT sample sets A, B and using

        L = mean((A − t) · (B − t))

    gives E[L] = ||E X − t||²/N exactly (the variance term cancels because A ⊥ B)
    and dL/dθ = mean((A−t)·∂B + (B−t)·∂A), an unbiased estimate of the true MSE
    gradient. This is the correct training loss; make_loss_fn's CRN form remains
    for finite-difference gradient tests.
    """

    def loss(params: SceneParams, target, key, pixel_ids=None):
        ka, kb = jax.random.split(key)
        sc = apply_params(scene, params)
        a = render_spp(sc, cfg, spp, ka, pixel_ids)
        b = render_spp(sc, cfg, spp, kb, pixel_ids)
        return jnp.mean((a - target) * (b - target))

    return loss


def make_train_step(scene: Scene, cfg: RenderConfig, spp: int, lr: float):
    """Single-device SGD step: (params, target, step_idx, key) → (params, loss).

    Plain SGD; for the ill-conditioned albedo problem (wall albedos see ~100×
    the gradient of small faces) prefer make_optax_train_step with adam.
    """
    loss_fn = make_loss_fn(scene, cfg, spp)

    @jax.jit
    def step(params: SceneParams, target, step_idx, key):
        skey = jax.random.fold_in(key, step_idx)
        loss, grads = jax.value_and_grad(loss_fn)(params, target, skey)
        params = jax.tree.map(
            lambda p, g: None if p is None else p - lr * g, params, grads,
            is_leaf=lambda x: x is None,
        )
        return params, loss

    return step


def make_optax_train_step(scene: Scene, cfg: RenderConfig, spp: int, optimizer,
                          clip01: bool = True, unbiased: bool = True):
    """Optimizer-driven step using any optax.GradientTransformation.

    Returns (step, opt_state0(params)) where
    step(params, opt_state, target, step_idx, key) → (params, opt_state, loss).
    `clip01` projects albedo/emissive leaves back into their physical ranges
    (albedo ∈ [0,1], emissive ≥ 0) after the update. `unbiased` (default) uses
    the pairwise two-sample loss whose gradient doesn't chase estimator variance
    (see make_unbiased_loss_fn) — the biased CRN loss is only right for
    finite-difference testing.
    """
    loss_fn = (make_unbiased_loss_fn if unbiased else make_loss_fn)(scene, cfg, spp)

    def project(params: SceneParams) -> SceneParams:
        if not clip01:
            return params
        albedo = None if params.albedo is None else jnp.clip(params.albedo, 0.0, 1.0)
        emissive = None if params.emissive is None else jnp.maximum(params.emissive, 0.0)
        rough = None if params.roughness is None else jnp.clip(
            params.roughness, 1e-4, 1.0)  # >0: r=0 kills the GGX lobe's AD
        return params._replace(albedo=albedo, emissive=emissive, roughness=rough)

    @jax.jit
    def step(params: SceneParams, opt_state, target, step_idx, key):
        skey = jax.random.fold_in(key, step_idx)
        loss, grads = jax.value_and_grad(loss_fn)(params, target, skey)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = project(optax_apply(params, updates))
        return params, opt_state, loss

    return step, optimizer.init


def optax_apply(params, updates):
    """optax.apply_updates that tolerates None leaves."""
    return jax.tree.map(
        lambda p, u: None if p is None else p + u, params, updates,
        is_leaf=lambda x: x is None,
    )


def make_sharded_train_step(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                            spp: int, lr: float):
    """Mesh train step: pixels shard over 'tiles', params replicate, grads psum.

    (params, target_sharded, pixel_ids_sharded, step_idx, key) → (params, loss).
    The psum is the ONLY collective — exactly the gradient all-reduce the north star
    specifies (SURVEY.md §5.8).
    """
    n_total = cfg.n_pixels

    def local_grads(params: SceneParams, scene_in: Scene, target, pixel_ids, skey):
        def local_loss(p):
            img = render_spp(apply_params(scene_in, p), cfg, spp, skey, pixel_ids)
            return l2_loss(img, target) / n_total  # local sum / global count

        loss, grads = jax.value_and_grad(local_loss)(params)
        loss = jax.lax.psum(loss, TILE_AXIS)
        grads = jax.tree.map(
            lambda g: None if g is None else jax.lax.psum(g, TILE_AXIS), grads,
            is_leaf=lambda x: x is None,
        )
        return loss, grads

    sharded = jax.shard_map(
        local_grads,
        mesh=mesh,
        in_specs=(P(), P(), P(TILE_AXIS), P(TILE_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(params: SceneParams, target, pixel_ids, step_idx, key):
        skey = jax.random.fold_in(key, step_idx)
        loss, grads = sharded(params, scene, target, pixel_ids, skey)
        params = jax.tree.map(
            lambda p, g: None if p is None else p - lr * g, params, grads,
            is_leaf=lambda x: x is None,
        )
        return params, loss

    return step
