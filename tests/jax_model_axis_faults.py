"""The JAX package's model axis against one device, for the record (not a
test: nothing here pins the JAX package's behaviour).

    JAX_PLATFORMS=cpu python -m tests.jax_model_axis_faults

One batch (n = 5 rows, B = 5) of each JAX FSW runner (the exact
shared-vocab ``DistanceEpochRunner`` and the lazy ``FSWLazyEpochRunner`` and
``FSWLazyPerGenomeRunner`` at R = 8) and of the dense runner, on
``make_mesh(1, 2)`` against ``make_mesh(1, 1)``, from the same params
(``tests/test_torch_model_axis.py``'s problems). After one Adam step the
first moment is 0.1 x the gradient, so the script prints, per parameter,
the least-squares ratio of the (1, 2) gradient to the (1, 1) one and the
largest residual, and whether the replicated ``lookup``'s moment is the
same on both model devices. A ratio of 2 is the factor n_model of
``shard_map`` with ``check_rep`` off (``kf2vecfsw_tpu/train/step.py:40-45``);
a ``lookup`` moment that differs between the devices is its gradient taken
from each device's own slices only (``kf2vecfsw_tpu/models/fsw.py:
613-656,705-712``). The biases of the distance model's last layer have a
gradient of rounding-noise size (the loss ignores a common shift of the
embeddings), so their ratio means nothing."""

import numpy as np

from . import conftest  # noqa: F401  (8 virtual CPU devices before JAX starts)

import jax  # noqa: E402

from kf2vecfsw_tpu.models import fsw as jfsw  # noqa: E402
from kf2vecfsw_tpu.models.mlp import dist_embed_apply, dist_embed_specs  # noqa: E402
from kf2vecfsw_tpu.parallel.mesh import MODEL_AXIS, make_mesh, shard_params  # noqa: E402
from kf2vecfsw_tpu.train.fsw_lazy import FSWLazyEpochRunner, FSWLazyPerGenomeRunner  # noqa: E402
from kf2vecfsw_tpu.train.step import DistanceEpochRunner, adam_init  # noqa: E402

from .test_torch_model_axis import K, REFRESH, problem  # noqa: E402

N = B = 5
FSW_SPECS = jfsw.fsw_dist_embed_specs(MODEL_AXIS)
RUNNERS = {
    "dense": (dist_embed_specs(MODEL_AXIS),
              lambda m: DistanceEpochRunner(m, dist_embed_apply, dist_embed_specs(MODEL_AXIS), N, B)),
    "fsw_shared": (FSW_SPECS, lambda m: DistanceEpochRunner(m, jfsw.make_fsw_shared_apply(K),
                                                            FSW_SPECS, N, B)),
    "fsw_lazy_shared": (FSW_SPECS, lambda m: FSWLazyEpochRunner(m, K, FSW_SPECS, N, B,
                                                                refresh_steps=REFRESH)),
    "fsw_lazy_pergenome": (FSW_SPECS, lambda m: FSWLazyPerGenomeRunner(m, K, FSW_SPECS, N, B,
                                                                       refresh_steps=REFRESH)),
}


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", tree[key]


def main() -> None:
    for name, (specs, make_runner) in RUNNERS.items():
        _, feats, target, params, _ = problem(name, 41, N)
        grads = {}
        for shape in ((1, 1), (1, 2)):
            mesh = make_mesh(*shape)
            runner = make_runner(mesh)
            p = shard_params(params, specs, mesh)
            _, opt, _ = runner.run_epoch(p, adam_init(p), runner.pad_items(feats),
                                         runner.pad_dist(target), jax.random.PRNGKey(0), 1e-5)
            grads[shape] = {k: np.asarray(v) / 0.1 for k, v in _leaves(jax.device_get(opt["mu"]))}
            if shape == (1, 2) and "lookup" in opt["mu"]:
                copies = [np.asarray(s.data) / 0.1 for s in opt["mu"]["lookup"].addressable_shards]
                true_max = np.abs(grads[(1, 1)]["lookup"]).max()
                print(f"{name}: lookup gradient on the two model devices: largest difference "
                      f"{np.abs(copies[0] - copies[1]).max() / true_max:.4f} x the true "
                      "gradient's largest element")
        for leaf, ref in grads[(1, 1)].items():
            got = grads[(1, 2)][leaf]
            ratio = float(np.sum(got * ref) / np.sum(ref * ref))
            resid = float(np.abs(got - ratio * ref).max() / np.abs(ref).max())
            print(f"  {name} {leaf}: ratio {ratio:.4f}, largest residual {resid:.2e}")


if __name__ == "__main__":
    main()
