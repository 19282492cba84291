"""Training window: the distance trainer's epochs back to back on one
subtree, as ``train/distance.py:_train_all`` runs them.

Set-up makes the subtree from the seed (a random backbone's patristic
distances, k-mer counts of genomes along it, as the port's readers hand
them to the trainer), builds one model and its Adam, and drives them
through the trainer's own epoch function: first ``checked_steps``
single-batch calls on rows that all differ, whose losses, first gradient
(from Adam's first moment after one step), change and first embeddings
(as the step hands them its loss) the reference follows, then the rest of the first epoch (every step shape, the lazy
route's first refresh). The window then runs whole epochs, each with the
trainer's learning rate, item order, route and loss fetch, until the
window's seconds have passed; the fetch ends every epoch on a synchronise.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import compare, counts, inputs
from ..reference import kmers as ref_kmers
from ..reference import models as ref_models

F32 = np.float32


def program_leaves(model) -> list[tuple[str, torch.nn.Parameter, bool]]:
    """(leaf name in the checkpoints' layout, parameter, stored transposed)."""
    out = []
    if hasattr(model, "lookup"):
        out += [("lookup", model.lookup, False), ("fsw/slices", model.slices, False),
                ("fsw/freqs", model.freqs, False)]
    for name in ("fc1", "fc2"):
        layer = getattr(model, name)
        out += [(f"{name}/w", layer.weight, True), (f"{name}/b", layer.bias, False)]
    return out


def leaves_of(model, get) -> dict[str, torch.Tensor]:
    """``get(parameter)`` of every leaf, in the checkpoints' layout, on the
    host."""
    return {k: (get(p).T if t else get(p)).detach().float().cpu()
            for k, p, t in program_leaves(model)}


def _masked(prog: dict, ref: dict, live: dict) -> tuple[dict, dict, list[str]]:
    """Both sides' leaves cut to their live entries, and the live leaves."""
    cut = {k: m.cpu() for k, m in live.items()}
    return ({k: prog[k].double()[cut[k]] for k in cut}, {k: ref[k].cpu()[cut[k]] for k in cut},
            list(cut))


def _dead_gaps(prog: dict, ref: dict, dead: dict, live: dict) -> dict[str, float]:
    """Each live leaf's gap of norms over its masked-out entries, over the
    median leaf's reference norm over live entries."""
    p, r, keys = _masked(prog, ref, dead)
    med = compare._median([float(v.norm()) for v in _masked(prog, ref, live)[1].values()])
    return {k: abs(float(p[k].norm()) - float(r[k].norm())) / med for k in keys}


def _candidates(side: dict, ref: dict, live: dict) -> dict:
    """Readings looked at beside the compared numbers (``control.py``)."""
    dead = {k: ~m for k, m in live.items()}
    e, r = side["embs"], ref["embs"]
    return {"emb_widest": [compare.max_rel(a, b) for a, b in zip(e, r)],
            "emb": [compare.rel_norm(a, b) for a, b in zip(e, r)],
            "change_dead": _dead_gaps(side["change"], ref["change"], dead, live)}


class Run:
    CHECKS_A_WINDOW = False  # the comparison reads set-up's checked steps

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, tracer):
        self.cfg, self.mix, self.seed, self.dev, self.tracer = cfg, mix, seed, device, tracer
        self.records: dict = {}
        self.lrs: dict[int, float] = {}  # each epoch's learning rate, as Adam holds it

    # -- set-up ------------------------------------------------------------------

    def setup(self) -> None:
        from kf2vecfsw_tpu_torch.train.step import epoch_order, make_adam

        cfg, dev = self.cfg, self.dev
        rng, gen = inputs.generators(self.seed, dev)
        n, k = cfg["subtree_size"], cfg["k"]
        children, length, gc, leaves = inputs.random_tree(rng, n)
        self.dist = torch.from_numpy(inputs.patristic(children, length, leaves).astype(F32)).to(dev)
        lo, hi = self.mix["genome_length"]
        self.counts = inputs.genome_counts(gen, k, gc, inputs.spread_lengths(rng, n, lo, hi), dev)
        freqs = self.counts / self.counts.sum(dim=1, keepdim=True)  # float64, as get_kmers writes them
        self.vocab = freqs.shape[1]
        if cfg["model"] == "fsw":
            feats = freqs.float()  # the shared route's (n, V) vocab weights
        else:
            feats = freqs.float() * F32(cfg["features_scaler"])  # `.kf` rows, as the trainer scales them
        self.params0 = inputs.model_params(gen, cfg, dev)
        self.model = self._program_model()
        self.opt = make_adam(self.model, cfg["lr"])
        self.epoch_fn = self._epoch_fn(feats)
        self.orders = torch.Generator().manual_seed(self.seed)  # the trainer's CPU generator
        self.n_batches = -(-n // cfg["batch_size"])
        self._first_steps(epoch_order(self.orders, n).to(dev))

    def _program_model(self):
        from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed
        from kf2vecfsw_tpu_torch.models.mlp import DistEmbed

        cfg = self.cfg
        with torch.device(self.dev):
            if cfg["model"] == "fsw":
                model = FSWDistEmbed(cfg["k"], cfg["base_dim"], cfg["fsw_out_dim"],
                                     cfg["hidden_size"], cfg["embedding_size"])
            else:
                model = DistEmbed(self.vocab, cfg["hidden_size"], cfg["embedding_size"])
        with torch.no_grad():
            for key, p, transposed in program_leaves(model):
                p.copy_(self.params0[key].T if transposed else self.params0[key])
        return model

    def _epoch_fn(self, feats: torch.Tensor):
        """The trainer's epoch function for this clade, with its route."""
        from kf2vecfsw_tpu_torch.models.fsw import shared_vocab_applicable
        from kf2vecfsw_tpu_torch.train.fsw_lazy import LazyPlanes, lazy_distance_epoch, pick_refresh_group
        from kf2vecfsw_tpu_torch.train.step import bucket_items, distance_epoch

        cfg, b = self.cfg, self.cfg["batch_size"]
        n = feats.shape[0]
        self.planes = None
        if cfg["model"] == "fsw":
            n_points = int((self.counts > 0).sum(dim=1).max())
            if not shared_vocab_applicable(cfg["k"], bucket_items(n_points, floor=128), b):
                raise NotImplementedError("this driver runs the shared-vocab FSW route only")
            group = pick_refresh_group(cfg["fsw_out_dim"], self.vocab, self.dev, 1, None, items=n)
            if cfg["fsw_lazy_refresh"] > 0 and group > 0:
                self.planes = LazyPlanes(feats, True, cfg["fsw_lazy_refresh"], -(-n // b), group)
        if self.planes is not None:
            planes = self.planes
            return lambda order: lazy_distance_epoch(self.model, self.opt, planes, self.dist,
                                                     order, b)
        return lambda order: distance_epoch(self.model, self.opt, feats, self.dist, order, b)

    def _set_lr(self, epoch: int) -> None:
        from kf2vecfsw_tpu_torch.train.schedule import step_lr
        from kf2vecfsw_tpu_torch.train.step import set_lr

        cfg = self.cfg
        set_lr(self.opt, step_lr(epoch, cfg["lr"], cfg["lr_min"], cfg["lr_decay"]))
        self.lrs[epoch] = self.opt.param_groups[0]["lr"]

    def _first_steps(self, order: torch.Tensor) -> None:
        """The checked steps, one batch a call, then the rest of epoch 0."""
        from kf2vecfsw_tpu_torch.train import step

        b, steps = self.cfg["batch_size"], self.mix["checked_steps"]
        self._set_lr(0)
        self.batches = [order[i * b : (i + 1) * b] for i in range(steps)]
        losses, self.embs = [], []
        batch_loss = step._distance_batch_loss

        def recorded(emb, *args):  # the embeddings each checked step hands its loss
            self.embs.append(emb.detach().double().cpu())
            return batch_loss(emb, *args)

        step._distance_batch_loss = recorded
        try:
            for i, idx in enumerate(self.batches):
                losses.append(float(self.epoch_fn(idx)))
                if i == 0:  # Adam's first moment after one step is (1 - beta1) g
                    beta1 = self.opt.param_groups[0]["betas"][0]
                    self.grad1 = leaves_of(self.model, lambda p: self.opt.state[p].get(
                        "exp_avg", torch.zeros_like(p)) / (1 - beta1))
        finally:
            step._distance_batch_loss = batch_loss
        self.losses = losses
        self.change = {k: v - self.params0[k].float().cpu()
                       for k, v in leaves_of(self.model, lambda p: p).items()}
        float(self.epoch_fn(order[steps * b:]))  # the rest of epoch 0: warms every shape
        self.setup_peak = torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0

    # -- window --------------------------------------------------------------------

    def window(self, seconds: float) -> None:
        from kf2vecfsw_tpu_torch.train.step import epoch_order

        tr = self.tracer
        n = self.cfg["subtree_size"]
        if tr.enabled:
            self._trace_wrappers()
        refreshes0 = self.planes.refreshes if self.planes is not None else 0
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        steps = failed = 0
        epoch = 1
        with tr.window():
            t0 = time.perf_counter()
            while True:
                self._set_lr(epoch)
                order = epoch_order(self.orders, n).to(self.dev)
                with tr.span("epoch"):
                    loss = self.epoch_fn(order)
                with tr.span("fetch"):
                    loss = float(loss)  # the epoch's one fetch, as the trainer's
                steps += self.n_batches
                failed += 0 if math.isfinite(loss) else self.n_batches
                epoch += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        self.window_s = time.perf_counter() - t0
        self.window_peak = (torch.cuda.max_memory_allocated(self.dev)
                            if self.dev.type == "cuda" else 0)
        self.records.update(
            steps=steps, failed=failed, epochs=epoch - 1,
            refreshes=(self.planes.refreshes - refreshes0) if self.planes is not None else 0,
            full_batches=(epoch - 1) * (n // self.cfg["batch_size"]),
            last_batch=n % self.cfg["batch_size"])

    def _trace_wrappers(self) -> None:
        """Traced runs only: the refresh timed between two synchronises, and
        every ``sort_rows`` launch's shape."""
        from kf2vecfsw_tpu_torch.models import fsw

        tr = self.tracer
        if self.planes is not None:
            refresh = self.planes.refresh

            def timed(model):
                tr.sync()
                with tr.span("refresh"):
                    refresh(model)
                    tr.sync()

            self.planes.refresh = timed
        tr.wrap(fsw, "sort_rows",
                record=lambda a, kw: (a[0].shape[0], a[0].shape[1], a[1].shape[0]))

    # -- results -------------------------------------------------------------------

    def end_to_end(self) -> dict[str, float]:
        return {"train_steps_per_s": self.records["steps"] / self.window_s,
                "train_peak_gib": self.window_peak / 2**30}

    def attempted_failed(self) -> tuple[int, int]:
        return self.records["steps"], self.records["failed"]

    def memory_peak(self) -> int:
        return max(self.setup_peak, self.window_peak)

    def release(self) -> None:
        del self.model, self.opt, self.epoch_fn, self.planes
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64) -> dict:
        """The reference's checked steps from the same inputs, computed in
        ``dtype``, the parameters kept in float32."""
        dev, cfg = self.dev, self.cfg
        lrs = {e: ref_models.step_lr(e, cfg["lr"], cfg["lr_min"], cfg["lr_decay"])
               for e in self.lrs}
        freqs = (self.counts / self.counts.sum(dim=1, keepdim=True))
        dist = self.dist.to(dtype)
        lr = self.cfg["lr"]
        if self.cfg["model"] == "fsw":
            digits = torch.from_numpy(ref_kmers.vocab_digits(self.cfg["k"])).to(dev)
            lazy = ref_models.LazyFSW(digits, freqs.to(dtype))
            return {**ref_models.train_steps(self.params0, lazy.embed, dist, self.batches, lr,
                                             lazy.refresh, dtype), "lrs": lrs}
        x = (freqs * self.cfg["features_scaler"]).to(dtype)
        return {**ref_models.train_steps(self.params0, lambda p, idx: ref_models.head(p, x[idx]),
                                         dist, self.batches, lr, compute=dtype), "lrs": lrs}

    def close(self) -> None:
        pass

    def numbers(self) -> dict[str, float]:
        """The program's checked steps against the reference's: each step's
        loss, the first gradient, the change after the last step, and the
        embeddings the first step hands its loss (both sides at the same
        parameters there; later steps' embeddings carry the parameters'
        drift, which the change covers), and every epoch's learning rate,
        the window's included."""
        self.ref = self.reference()
        return self._numbers(self.program(), self.ref)

    def program(self) -> dict:
        return {"losses": self.losses, "grad1": self.grad1, "change": self.change,
                "embs": self.embs, "lrs": dict(self.lrs)}

    def leaf_readings(self) -> dict:
        """Each leaf's gradient gap and each live leaf's change gap, over its
        live entries and over all of them (for ``control.py``)."""
        live = compare.live_entries(self.ref["grad1"])
        out = {"grad": compare.leaf_gaps(self.grad1, self.ref["grad1"], list(self.ref["grad1"])),
               "change": compare.leaf_gaps(*_masked(self.change, self.ref["change"], live)),
               "change_all_entries": compare.leaf_gaps(self.change, self.ref["change"],
                                                       list(live)),
               "program": _candidates(self.program(), self.ref, live)}
        if getattr(self, "control", None) is not None:
            out["control"] = _candidates(self.control, self.ref, live)
        return out

    def control_numbers(self) -> dict[str, float]:
        """The reference's checked steps with TF32 products, in the
        program's place."""
        if not hasattr(self, "ref"):
            self.ref = self.reference()
        with ref_models.tf32_products():
            self.control = self.reference(torch.float32)
        return self._numbers(self.control, self.ref)

    @staticmethod
    def _numbers(prog: dict, ref: dict) -> dict[str, float]:
        live = compare.live_entries(ref["grad1"])
        return {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"]),
                "grad_gap": compare.norm_gap(prog["grad1"], ref["grad1"], list(ref["grad1"])),
                "change_gap": compare.norm_gap(*_masked(prog["change"], ref["change"], live)),
                "emb_gap": compare.rel_norm(prog["embs"][0], ref["embs"][0]),
                "lr_gap": max(abs(prog["lrs"][e] - ref["lrs"][e]) / ref["lrs"][e]
                              for e in ref["lrs"])}

    def flops(self) -> float:
        """Operations of the window's steps and refreshes, from shapes."""
        r, cfg = self.records, self.cfg
        f = (r["full_batches"] * counts.train_step_flops(cfg, self.vocab, cfg["batch_size"])
             + r["epochs"] * (counts.train_step_flops(cfg, self.vocab, r["last_batch"])
                              if r["last_batch"] else 0))
        if r["refreshes"]:
            f += r["refreshes"] * counts.shared_refresh_flops(cfg, self.vocab, cfg["subtree_size"])
        return f
