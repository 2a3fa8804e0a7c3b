"""ResNet50 classification on the port: the full contrib stack in one loop.

Counterpart of ``examples/imagenet_resnet.py`` (the reference Bagua's
``examples/imagenet/main.py``):

- ``CachedDataset`` over the TCP store (the native server where it is
  built): a sample's slow decode is paid once;
- ``LoadBalancingDistributedSampler``: complexity-balanced shards, one a
  rank;
- ``SyncBatchNorm`` in ``ResNet``'s norms: batch statistics over the ranks;
- ``fuse_optimizer``: SGD with momentum over fused buffers;
- ``--algorithm gradient_allreduce`` or ``bytegrad`` (the MinMaxUInt8
  codec, K1 and K2 on the card, at world 2 or more).

Synthetic ImageNet-shaped data by default; ``--data-dir`` reads a directory
of ``{class}/{img}.npy`` arrays.  Full ResNet50 at 224 px unless ``--tiny``.

    python examples/torch/imagenet_resnet.py --steps 4 --tiny --device cpu
    bagua-tpu-torch-run --nproc_per_node 2 examples/torch/imagenet_resnet.py --algorithm bytegrad
"""

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bagua_tpu_torch as bt  # noqa: E402
from bagua_tpu_torch.contrib import (  # noqa: E402
    CachedDataset,
    LoadBalancingDistributedSampler,
    SyncBatchNorm,
    fuse_optimizer,
)
from bagua_tpu_torch.device import resolve_device  # noqa: E402
from bagua_tpu_torch.models.resnet import ResNet, ResNet50, classification_loss_fn  # noqa: E402


class SyntheticImageNet:
    """ImageNet-shaped HWC samples (N(0, 1) from the index's seed, as the JAX
    example's) with a deterministic 'decode' cost."""

    def __init__(self, n, size, classes):
        self.n, self.size, self.classes = n, size, classes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        img = rng.normal(size=(self.size, self.size, 3)).astype(np.float32)
        return img, int(i % self.classes)


class NpyDirImageNet:
    """Real images from ``{data_dir}/{class_name}/*.npy``, each one HWC
    float or uint8 array; labels in sorted class-directory order; arrays
    center-cropped or padded to ``size``, uint8 ranges scaled to [-1, 1]."""

    def __init__(self, data_dir, size):
        self.size = size
        self.items = []
        classes = sorted(d for d in os.listdir(data_dir)
                         if os.path.isdir(os.path.join(data_dir, d)))
        self.classes = len(classes)
        for label, cls in enumerate(classes):
            cdir = os.path.join(data_dir, cls)
            self.items += [(os.path.join(cdir, f), label)
                           for f in sorted(os.listdir(cdir)) if f.endswith(".npy")]
        if not self.items:
            raise FileNotFoundError(f"no {{class}}/*.npy under {data_dir}")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        path, label = self.items[i]
        img = np.load(path).astype(np.float32)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        if img.max() > 2.0:
            img = img / 127.5 - 1.0
        s = self.size
        h, w = img.shape[:2]
        if h < s or w < s:
            img = np.pad(img, ((0, max(0, s - h)), (0, max(0, s - w)), (0, 0)))
            h, w = img.shape[:2]
        top, left = (h - s) // 2, (w - s) // 2
        return img[top:top + s, left:left + s, :3], label


class _Subset:
    """Index-remapped view (the train split) over a dataset or cache."""

    def __init__(self, base, idx):
        self.base, self.idx = base, idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.base[self.idx[i]]


def _nchw(samples, device):
    images = torch.from_numpy(np.stack([s[0] for s in samples])).permute(0, 3, 1, 2)
    return images.to(device).contiguous(memory_format=torch.channels_last)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-per-device", type=int, default=8, help="images a rank a step")
    ap.add_argument("--algorithm", default="gradient_allreduce",
                    choices=["gradient_allreduce", "bytegrad"])
    ap.add_argument("--tiny", action="store_true",
                    help="small ResNet + 64px images for CPU runs")
    ap.add_argument("--data-dir", type=str, default=None,
                    help="directory of {class}/{img}.npy real images")
    ap.add_argument("--epochs", type=int, default=1,
                    help="passes over the real dataset (with --data-dir)")
    ap.add_argument("--eval-frac", type=float, default=0.2,
                    help="held-out fraction for the accuracy gate")
    ap.add_argument("--gate-accuracy", type=float, default=None,
                    help="fail unless held-out accuracy reaches this")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(args, params=None) -> dict:
    """Train.  ``params``: a flax param tree of the JAX example's ``ResNet``
    (numpy), loaded through ``params_from_jax``; None draws from seed 0.
    Returns the losses, the sample indices of this rank's first batch, the
    cache's entry count and, with ``--data-dir``, the held-out accuracy."""
    device = resolve_device(args.device)
    bt.init_process_group(device=device)
    world, rank = bt.get_world_size(), bt.get_rank()
    batch = args.batch_per_device
    size = 64 if args.tiny else 224
    real = NpyDirImageNet(args.data_dir, size) if args.data_dir else None
    classes = real.classes if real else (16 if args.tiny else 1000)
    mesh = bt.build_mesh({"dp": world})
    bt.set_global_mesh(mesh)
    try:
        norm_cls = functools.partial(SyncBatchNorm, axis_name="dp")
        if args.tiny:
            model = ResNet(stage_sizes=(1, 1), num_classes=classes, num_filters=16,
                           norm_cls=norm_cls, device=device)
        else:
            model = ResNet50(num_classes=classes, norm_cls=norm_cls, device=device)
        if params is not None:
            from bagua_tpu_torch.models.convert import params_from_jax

            model.load_state_dict(params_from_jax(params, model), strict=False)
        dataset = real if real else SyntheticImageNet(batch * world * 8, size, classes)
        eval_idx, train_idx = [], list(range(len(dataset)))
        if real is not None and args.eval_frac > 0:
            perm = np.random.default_rng(0).permutation(len(dataset))
            n_eval = max(1, int(len(dataset) * args.eval_frac))
            eval_idx, train_idx = list(perm[:n_eval]), list(perm[n_eval:])
        cached = CachedDataset(dataset, backend="tcp", dataset_name="imagenet",
                               writer_buffer_size=8, num_shards=2)
        sampler = LoadBalancingDistributedSampler(
            _Subset(cached, train_idx), complexity_fn=lambda s: int(abs(s[0]).sum() * 100),
            num_replicas=world, rank=rank)
        algo = (bt.ByteGradAlgorithm(hierarchical=False) if args.algorithm == "bytegrad"
                else bt.GradientAllReduceAlgorithm())
        opt = fuse_optimizer(functools.partial(torch.optim.SGD, lr=args.lr, momentum=0.9))
        trainer = bt.BaguaTrainer(classification_loss_fn, opt, algo, device=device, mesh=mesh,
                                  model_name="imagenet_resnet")
        state = trainer.init(model)
        indices = list(sampler)         # positions into train_idx: this rank's shard
        steps = args.epochs * max(1, len(indices) // batch) if real else args.steps
        losses, first = [], None
        for step in range(steps):
            sel = [train_idx[indices[(step * batch + j) % len(indices)]] for j in range(batch)]
            first = sel if first is None else first
            samples = [cached[i] for i in sel]
            data = {"images": _nchw(samples, device),
                    "labels": torch.tensor([s[1] for s in samples], device=device)}
            state, loss = trainer.train_step(state, data)
            losses.append(loss.item())
            print(f"step {step} loss {losses[-1]:.4f}", flush=True)
        cached.cache_loader.fetcher.flush_write_map()
        n_cached = cached.cache_loader.num_keys()
        cached.cache_loader.store.shutdown()
        print(f"final_loss {losses[-1]:.6f} cache_entries {n_cached}", flush=True)
        assert np.isfinite(losses[-1])
        out = {"losses": losses, "first_samples": [int(i) for i in first],
               "cache_entries": n_cached, "world": world, "model": model, "trainer": trainer}
        if eval_idx:
            out["eval_accuracy"] = evaluate(args, model, dataset, eval_idx, batch, device)
    finally:
        bt.set_global_mesh(None)
    return out


@torch.no_grad()
def evaluate(args, model, dataset, eval_idx, batch, device) -> float:
    """Held-out accuracy with batch-mode normalization (the trainer keeps
    the running statistics frozen; see ``classification_loss_fn``)."""
    correct = 0
    for i0 in range(0, len(eval_idx), batch):
        samples = [dataset[i] for i in eval_idx[i0:i0 + batch]]
        logits = model(_nchw(samples, device), train=True, update_stats=False)
        correct += int((logits.argmax(-1).cpu().numpy()
                        == np.array([s[1] for s in samples])).sum())
    acc = correct / max(1, len(eval_idx))
    print(f"eval_accuracy {acc:.4f} ({len(eval_idx)} held-out samples)", flush=True)
    if args.gate_accuracy is not None:
        assert acc >= args.gate_accuracy, (
            f"held-out accuracy {acc:.3f} below gate {args.gate_accuracy}")
    return acc


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
