"""MNIST GP classification — examples/src/main/scala/Mnist.scala.

The reference ships an IDX-gzip reader but never wires it to a GP
(Mnist.scala:30-84, SURVEY.md §2.2); here the reader is reproduced *and*
connected to the softmax-Laplace classifier
(``gpx_torch.models.classify``). With no MNIST files given, a synthetic
blob-digit data set exercises the same pipeline.

Usage: python -m gpx_torch.examples.mnist_classify
           [--images t10k-images-idx3-ubyte.gz
            --labels t10k-labels-idx1-ubyte.gz]
"""

import gzip
import pathlib
import struct

import numpy as np
import torch

from gpx_torch._device import resolve_device
from gpx_torch import se, white
from gpx_torch.examples import _common
from gpx_torch.models import classify


def read_idx_images(path):
    """IDX image reader (magic 2051) — Mnist.scala:30-58."""
    with gzip.open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad magic for images: {magic}")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows * cols).astype(np.float32) / 255.0


def read_idx_labels(path):
    """IDX label reader (magic 2049) — Mnist.scala:60-84."""
    with gzip.open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad magic for labels: {magic}")
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)


def synthetic_digits(rng, n_per=30, n_classes=4, dim=16):
    """Gaussian blobs in pixel space — same pipeline, no dataset needed."""
    centers = rng.normal(size=(n_classes, dim)) * 2.0
    xs = np.concatenate(
        [centers[c] + rng.normal(size=(n_per, dim)) * 0.8
         for c in range(n_classes)]
    )
    ys = np.repeat(np.arange(n_classes), n_per)
    return xs.astype(np.float32), ys


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--images", type=str, default=None)
    ap.add_argument("--labels", type=str, default=None)
    ap.add_argument("--n-train", type=int, default=200)
    ap.add_argument("--n-test", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    if args.images and pathlib.Path(args.images).exists():
        xs = read_idx_images(args.images)
        ys = read_idx_labels(args.labels)
        n_classes = 10
    else:
        print("no MNIST files given; using synthetic blob digits")
        xs, ys = synthetic_digits(rng)
        n_classes = 4

    perm = rng.permutation(len(xs))
    xs, ys = xs[perm], ys[perm]
    # the synthetic data has 120 points; clamp the split so the default
    # --n-train 200 still leaves a test set instead of 0 points
    n_train = min(args.n_train, max(len(xs) - args.n_test, 1))
    x_train = torch.as_tensor(xs[:n_train], device=device)
    y_train = torch.as_tensor(ys[:n_train], device=device)
    x_test = torch.as_tensor(xs[n_train:n_train + args.n_test],
                             device=device)
    y_test = ys[n_train:n_train + args.n_test]

    kern = se(1.0, 8.0, device=device) + white(0.1, device=device)
    fitres = classify.fit(x_train, kern, y_train, n_classes)
    print(f"Laplace fit: {int(fitres.n_iters)} Newton iters, "
          f"logZ = {float(fitres.log_marginal):.1f}")
    probs = classify.predict(_common.generator(device, 1), fitres, x_train,
                             kern, x_test)
    pred = probs.argmax(-1).cpu().numpy()
    acc = (pred == y_test[: len(pred)]).mean()
    print(f"test accuracy on {len(pred)} points: {acc:.2%}")
    return {"fit": fitres, "probs": probs, "accuracy": float(acc),
            "n_classes": n_classes}


if __name__ == "__main__":
    main()
