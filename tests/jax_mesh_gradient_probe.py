"""Why the flagship step of the port stands farther from JAX's step on
the 8-device CPU mesh than from JAX's step run as one program, on the
batch of ``tests/test_torch_parallel.py`` (halves' mask areas ~30×
apart). Not a test: run it and read what it prints.

    JAX_PLATFORMS=cpu python -m tests.jax_mesh_gradient_probe

It prints, for two gradient components of ~1e-9, JAX's one-program
gradient, ``jax.grad`` with the batch sharded over the mesh, the gradient
the mesh step's first Adam update implies (``u = −lr·g / (|g| + ε)``
inverted) and the port's; the distance between JAX's two first updates;
and the port's world-1 first update against JAX's mesh step with Adam's
ε at 1e-8 (the recipe's), 1e-6 and 1e-5 in both packages (readings of
``test_torch_parallel.py::_param_errors``: well-determined components'
max |Δ| / lr, max |Δ| / lr, ‖Δ‖ / ‖movement‖).
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import copy  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from endosr.models.f_depthcond import FModelDepthCond as JaxModel  # noqa: E402
from endosr.parallel.mesh import make_mesh, replicate  # noqa: E402
from endosr_torch.models.f_depthcond import FModelDepthCond  # noqa: E402
from endosr_torch.utils.port_params import from_flax_train  # noqa: E402
from tests.test_torch_parallel import _param_errors, _unequal_batch  # noqa: E402
from tests.test_torch_train import FLAGSHIP, K, _jax_loss_fn, _opt  # noqa: E402
from tests.torch_dist_common import _run_steps  # noqa: E402
from tests.torch_models_common import quick_flax_init, tree_np  # noqa: E402

COMPONENTS = [("netG.encoder.layer4.weight_v", 16413),
              ("netG.depth-residual1.norm1.mlp_beta_s.weight", 7493)]


def _jax_model(opt, mesh, eps):
    adam = optax.scale_by_adam
    optax.scale_by_adam = functools.partial(adam, eps=eps)
    try:
        with quick_flax_init(0):
            return JaxModel(copy.deepcopy(opt), mesh=mesh)
    finally:
        optax.scale_by_adam = adam


def main():
    torch.set_num_threads(1)
    opt, batch, lr = _opt(FLAGSHIP), _unequal_batch(), FLAGSHIP["lr_G"]
    mesh = make_mesh(jax.devices()[:8])
    first = np.int32(np.random.default_rng(FLAGSHIP["manual_seed"])
                     .integers(0, K))
    for eps in (1e-8, 1e-6, 1e-5):
        jm = _jax_model(opt, mesh, eps)
        state0 = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.state))
        jm.state = jm.state.replace(step=replicate(jm.state.step, mesh))
        start = from_flax_train(tree_np(state0.params))
        grad = jax.jit(jax.grad(_jax_loss_fn(jm), has_aux=True))
        one = dict(batch, mask_bin=first)
        g_one = from_flax_train(tree_np(grad(state0.params, one)[0]))
        sharded = {k: jax.device_put(v, NamedSharding(mesh, PartitionSpec(
            "data"))) if np.ndim(v) else v for k, v in one.items()}
        g_mesh = from_flax_train(tree_np(grad(state0.params, sharded)[0]))
        state1, _ = jax.jit(jm._train_step.__wrapped__)(state0, one)
        p_one = from_flax_train(tree_np(state1.params))
        jm.feed_data(batch)
        jm.optimize_parameters(1)
        p_mesh = from_flax_train(tree_np(jm.state.params))
        tm = FModelDepthCond(copy.deepcopy(opt), device="cpu")
        tm.optimizer_G.param_groups[0]["eps"] = eps
        with torch.no_grad():
            for name, p in tm.named_train_parameters():
                p.copy_(start[name])
        port = _run_steps(tm, batch, 1)
        print(f"Adam eps {eps:g}")
        if eps == 1e-8:
            for k, i in COMPONENTS:
                u = float((p_mesh[k] - start[k]).flatten()[i]) / lr
                implied = -eps * u / (1 - abs(u))
                print(f"  {k}[{i}]: one program "
                      f"{float(g_one[k].flatten()[i]):.5g}, sharded jax.grad "
                      f"{float(g_mesh[k].flatten()[i]):.5g}, implied by the "
                      f"mesh step {implied:.5g}, the port "
                      f"{float(port['grads'][k].flatten()[i]):.5g}")
            print("  JAX one program against JAX's mesh step:",
                  _param_errors(p_one, p_mesh, start, g_one, g_one, lr))
        print("  the port's world 1 against JAX's mesh step:",
              _param_errors(port["params"][1], p_mesh, start, port["grads"],
                            g_one, lr))


if __name__ == "__main__":
    main()
