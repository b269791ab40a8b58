"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
JAX side runs under ``jax.jit``.  Configuration: mixtral-8x7b's smoke
variant (d 256, 4 experts, top-2, d_ff 512, float32), with dense or
capacity dispatch.  Token counts 256, 300 and 5: one full group, a
padded second group (300 = 256 + 44 real rows and 212 zero rows) and a
decode-sized group.

Tolerance: float32 rtol 1e-4 / atol 1e-5 on outputs and the aux loss
(the two packages sum their products in different orders); on gradients
rtol 1e-4 and atol 1e-5 times the leaf's largest |value| (a router
gradient sums ~30-sized terms over the tokens, so its entries near zero
carry the sum's rounding); routes (top-k indices) exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.models import moe as tmoe
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

TOL = dict(rtol=1e-4, atol=1e-5)
TOKENS = [256, 300, 5]


def configs(**changes):
    base = "mixtral-8x7b"
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[base]), **changes),
            dataclasses.replace(smoke_variant(ARCHS[base]), **changes))


def params_np(cfg, seed: int = 0, router_scale: float = 1.0, skew: float = 0.0):
    """The layer's parameters at the reference's scales, drawn with numpy;
    ``skew`` adds to expert 0's router column (to overflow its capacity)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d) * router_scale,
         "up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    p["router"][:, 0] += skew
    return {k: v.astype(np.float32) for k, v in p.items()}


def tokens_np(t: int, d: int, seed: int = 1):
    return np.random.default_rng(seed).standard_normal((1, t, d)).astype(np.float32)


def torch_tree(p, grad: bool = False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in p.items()}


def close(ours, theirs, what: str, scaled: bool = False) -> float:
    """Held at TOL; ``scaled``: atol times max(1, the largest |theirs|)."""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    tol = dict(TOL)
    if scaled and theirs.size:
        tol["atol"] *= max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours, theirs, **tol, err_msg=what)
    return float(np.abs(ours - theirs).max()) if ours.size else 0.0


def test_constants_are_the_reference_ones():
    assert tmoe.MOE_GROUP == jmoe.MOE_GROUP == 256


def test_init_moe_has_the_reference_leaves():
    jcfg, tcfg = configs()
    pj = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    pt = tmoe.init_moe(tcfg, torch.bfloat16, generator=torch.Generator().manual_seed(0),
                       device="cpu", lead=(3,))
    for name, leaf in pj.items():
        assert tuple(pt[name].shape) == (3,) + leaf.shape and pt[name].dtype == torch.bfloat16
    std = pt["down"].float().std().item()
    assert abs(std * np.sqrt(tcfg.d_ff) - 1.0) < 0.05


@pytest.mark.parametrize("case", ["random", "equal_logits"])
@pytest.mark.parametrize("t", TOKENS)
def test_route_matches_jax(t, case):
    """_route: gates, probabilities and the top-k indices, exactly.  With
    all logits equal (a zero router: every row's probabilities uniform, as
    a padding row's are) JAX's top_k picks experts 0 and 1."""
    jcfg, tcfg = configs()
    p = params_np(tcfg, seed=t)
    if case == "equal_logits":
        p["router"][:] = 0.0
    x = tokens_np(t, tcfg.d_model, seed=t + 1)[0]
    gj, pj, ij = jax.jit(lambda p, x: jmoe._route(p, x, jcfg))(p, x)
    gt, pt, it = tmoe._route(torch_tree(p), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    if case == "equal_logits":
        assert (it.numpy() == [0, 1]).all()
    err = max(close(gt, gj, "gates"), close(pt, pj, "probs"))
    print(f"t={t} {case}: routes equal, max |gates, probs diff| {err:.2e}")


def _jax_value_and_grads(fn, p, x, cot):
    def loss(p, x):
        out, aux = fn(p, x)
        return jnp.sum(out * cot) + aux, (out, aux)
    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                        has_aux=True))(p, x)
    return out, aux, grads


def _torch_value_and_grads(fn, p, x, cot):
    pt, xt = torch_tree(p, grad=True), torch.from_numpy(x.copy()).requires_grad_()
    out, aux = fn(pt, xt)
    (out * torch.from_numpy(cot)).sum().add(aux).backward()
    return out.detach(), aux.detach(), ({k: v.grad for k, v in pt.items()}, xt.grad)


def _check_layer(dispatch, t, jcfg, tcfg, p, seed):
    x = tokens_np(t, tcfg.d_model, seed)
    cot = np.random.default_rng(seed + 7).standard_normal(x.shape).astype(np.float32)
    jfn = {"dense": jmoe.moe_dense, "capacity": jmoe.moe_capacity}[dispatch]
    tfn = {"dense": tmoe.moe_dense, "capacity": tmoe.moe_capacity}[dispatch]
    oj, aj, (gpj, gxj) = _jax_value_and_grads(lambda p, x: jfn(p, x, jcfg), p, x, cot)
    ot, at, (gpt, gxt) = _torch_value_and_grads(lambda p, x: tfn(p, x, tcfg), p, x, cot)
    errs = [close(ot, oj, "output"), close(at, aj, "aux loss"),
            close(gxt, gxj, "dL/dx", scaled=True)]
    for name in p:
        errs.append(close(gpt[name], gpj[name], f"dL/d{name}", scaled=True))
    return max(errs)


@pytest.mark.parametrize("t", TOKENS)
def test_moe_dense_matches_jax(t):
    """moe_dense: output, aux loss, and the gradients of ⟨out, cot⟩ + aux
    in x and every parameter."""
    jcfg, tcfg = configs()
    err = _check_layer("dense", t, jcfg, tcfg, params_np(tcfg, seed=3), seed=t)
    print(f"dense t={t}: max |diff| {err:.2e}")


CAPACITY_CASES = {"cf1.25": dict(), "overflow": dict(capacity_factor=0.5)}


@pytest.mark.parametrize("case", sorted(CAPACITY_CASES))
@pytest.mark.parametrize("t", TOKENS)
def test_moe_capacity_matches_jax(t, case):
    """moe_capacity: output, aux loss and gradients.  t = 300 pads a
    second group with 212 zero rows, whose uniform probabilities route to
    experts 0 and 1 (the tie-break) and take their capacity; "overflow"
    (capacity factor 0.5, expert 0's router skewed) drops routes in both
    slots."""
    jcfg, tcfg = configs(moe_dispatch="capacity", **CAPACITY_CASES[case])
    skew = 0.2 if case == "overflow" else 0.0
    p = params_np(tcfg, seed=4, skew=skew)
    err = _check_layer("capacity", t, jcfg, tcfg, p, seed=t + 11)
    print(f"capacity {case} t={t}: max |diff| {err:.2e}")


def _kept_routes(cfg, x, top_i):
    """(token, expert) routes that moe_capacity keeps, recomputed from the
    top-k indices with numpy (the reference's slot-by-slot positions)."""
    t_pad, k = top_i.shape
    g = min(jmoe.MOE_GROUP, x.shape[0])
    cap = min(g, max(1, int(np.ceil(g * k * cfg.capacity_factor / cfg.n_experts))))
    kept = set()
    for g0 in range(0, t_pad, g):
        used = np.zeros(cfg.n_experts, int)
        for c in range(k):
            count = used.copy()
            for row in range(g0, g0 + g):
                e = top_i[row, c]
                if count[e] < cap:
                    kept.add((row, e))
                count[e] += 1
            used = np.minimum(count, cap)
    return kept


@pytest.mark.parametrize("case", sorted(CAPACITY_CASES))
def test_padded_capacity_routes_equal_jax(case):
    """At t = 300 the routes of the padded token rows are JAX's exactly,
    and so is the set of routes that capacity keeps; under torch.topk's
    tie-break the zero rows would fill other experts and the kept set of
    the real rows would differ (checked: the control below)."""
    jcfg, tcfg = configs(moe_dispatch="capacity", **CAPACITY_CASES[case])
    p = params_np(tcfg, seed=4, skew=0.2 if case == "overflow" else 0.0)
    x = tokens_np(300, tcfg.d_model, seed=5)[0]
    xp = np.concatenate([x, np.zeros((212, x.shape[1]), np.float32)])
    _, _, ij = jax.jit(lambda p, x: jmoe._route(p, x, jcfg))(p, xp)
    _, _, it = tmoe._route(torch_tree(p), torch.from_numpy(xp), tcfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (it.numpy()[300:] == [0, 1]).all()
    kept = _kept_routes(tcfg, xp, it.numpy())
    _, topk_i = torch.topk(tmoe._route(torch_tree(p), torch.from_numpy(xp), tcfg)[1], 2)
    other = _kept_routes(tcfg, xp, topk_i.numpy())
    real = lambda s: {r for r in s if r[0] < 300}
    assert real(kept) != real(other)
    dropped = 2 * 300 - len(real(kept))
    print(f"{case}: {dropped} of 600 real routes dropped; under torch.topk's "
          f"tie-break {len(real(other))} would be kept, a different set")
    # the output of the real rows equals JAX's (which these routes decide)
    out_j, _ = jax.jit(lambda p, x: jmoe.moe_capacity(p, x, jcfg))(p, x[None])
    out_t, _ = tmoe.moe_capacity(torch_tree(p), torch.from_numpy(x[None]), tcfg)
    close(out_t, out_j, "output")


def test_moe_dispatches_by_config():
    jcfg, tcfg = configs(moe_dispatch="capacity")
    p, x = params_np(tcfg), tokens_np(40, tcfg.d_model)
    out, aux = tmoe.moe(torch_tree(p), torch.from_numpy(x), tcfg)
    ref, ref_aux = tmoe.moe_capacity(torch_tree(p), torch.from_numpy(x), tcfg)
    assert torch.equal(out, ref) and torch.equal(aux, ref_aux)
    out, _ = tmoe.moe(torch_tree(p), torch.from_numpy(x), smoke_variant(ARCHS["mixtral-8x7b"]))
    assert torch.equal(out, tmoe.moe_dense(torch_tree(p), torch.from_numpy(x),
                                           smoke_variant(ARCHS["mixtral-8x7b"]))[0])


def test_no_gradient_through_the_dispatch_or_token_fractions():
    """The aux loss's gradient reaches the router only through the mean
    probabilities: with the token fractions held, it equals E·f_e/T."""
    _, tcfg = configs()
    p = torch_tree(params_np(tcfg), grad=True)
    x = torch.from_numpy(tokens_np(64, tcfg.d_model)[0])
    gates, probs, _ = tmoe._route(p, x, tcfg)
    aux = tmoe.load_balance_loss(probs, gates, tcfg.n_experts)
    (g_probs,) = torch.autograd.grad(aux, probs, retain_graph=True)
    frac = (gates > 0).float().mean(0)
    expect = (tcfg.n_experts * frac / x.shape[0]).expand_as(g_probs)
    torch.testing.assert_close(g_probs, expect)


def test_act_batch_axis_constraint_is_numerically_neutral(tmp_path):
    """``cfg.act_batch_axis`` (the JAX package's ``with_sharding_constraint``
    on the tokens): on plain tensors the capacity dispatch is bit for bit
    the one without it; on DTensors over a 1-rank gloo ``("data",)`` mesh,
    where each constraint is a redistribution, the output and the aux loss
    equal the plain ones within 1e-6 (the JAX package's own tolerance for
    this check)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import process_group

    _, tcfg = configs(moe_dispatch="capacity")
    cfg_wsc = dataclasses.replace(tcfg, act_batch_axis="data")
    p = torch_tree(params_np(tcfg))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 128, tcfg.d_model)).astype(np.float32) * 0.5)
    y, aux = tmoe.moe_capacity(p, x, tcfg)
    y_wsc, aux_wsc = tmoe.moe_capacity(p, x, cfg_wsc)
    assert torch.equal(y, y_wsc) and torch.equal(aux, aux_wsc)
    with process_group(str(tmp_path / "rendezvous")):
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        rep = lambda a: DTensor.from_local(a, mesh, [Replicate()], run_check=False)
        with implicit_replication():
            y_d, aux_d = tmoe.moe_capacity({k: rep(v) for k, v in p.items()}, rep(x),
                                           cfg_wsc)
        np.testing.assert_allclose(y_d.full_tensor().numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(float(aux_d.full_tensor()), float(aux), rtol=1e-6)
