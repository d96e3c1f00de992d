"""Quickstart on the PyTorch port (``repro_torch``; the JAX package's twin
is ``examples/quickstart.py``): train the paper's Figure-2 deep CNN
("Sukiyaki") with the modified AdaGrad on a CIFAR-like synthetic set, then
save and reload the model in the paper's JSON+base64 format.

The optimizer is ``adagrad(use_kernel=True)``: on the card every step is
one launch of the fused AdaGrad kernel (K2) for all eight leaves, and the
demo prints the launch count; ``--device cpu`` runs its plain version.
The step (loss, gradients and update, ``cnn.train_step``) runs through a
``StepGraph``, as the JAX quickstart jits it: on the card the first step
runs eagerly and every later one replays one CUDA graph, K2 inside it.

  PYTHONPATH=src python examples/torch_quickstart.py [--batches 100]
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import (load_json_model,  # noqa: E402
                                    save_json_model)
from repro_torch.configs.paper_cnn import FIG2_CNN  # noqa: E402
from repro_torch.data import clustered_images  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.adagrad.ops import adagrad_update_leaves  # noqa: E402
from repro_torch.launch.graphs import StepGraph  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import adagrad  # noqa: E402
from repro_torch.tree import to_numpy  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--beta", type=float, default=1.0,
                    help="the paper's AdaGrad β")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "sukiyaki_model.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ccfg = FIG2_CNN
    params = cnn.init_cnn(torch.Generator().manual_seed(0), ccfg,
                          device=dev)
    opt = adagrad(args.lr, beta=args.beta, use_kernel=True)
    opt_state = opt.init(params)
    images, labels = clustered_images(4096, image_size=ccfg.image_size,
                                      channels=ccfg.in_channels, seed=0)
    test_x, test_y = clustered_images(512, image_size=ccfg.image_size,
                                      channels=ccfg.in_channels, seed=9)
    images, labels = (torch.from_numpy(a).to(dev) for a in (images, labels))
    test_x, test_y = (torch.from_numpy(a).to(dev) for a in (test_x, test_y))
    step = StepGraph(cnn.train_step(ccfg, opt), (params, opt_state))

    bs = ccfg.batch_size
    adagrad_update_leaves.launches = 0
    t0 = time.time()
    for i in range(args.batches):
        j = (i * bs) % (len(images) - bs)
        (params, opt_state), loss = step((images[j:j + bs],
                                          labels[j:j + bs]))
        if i % 20 == 0 or i == args.batches - 1:
            with torch.no_grad():
                err = float(cnn.error_rate(cnn.forward(params, ccfg, test_x),
                                           test_y))
            print(f"batch {i:4d} loss {float(loss):.4f} "
                  f"test_err {err:.3f}", flush=True)
    dt = time.time() - t0
    print(f"trained {args.batches} batches in {dt:.1f}s "
          f"({args.batches/dt*60:.1f} batches/min)")
    launches = adagrad_update_leaves.launches
    print(f"kernel launches: adagrad={launches} ({args.batches} steps on "
          f"{dev.type})", flush=True)
    if dev.type == "cuda":
        assert launches == args.batches, launches

    save_json_model(args.out, params)
    rt = load_json_model(args.out)
    assert np.array_equal(to_numpy(params["convs"][0]["w"]),
                          to_numpy(rt["convs"][0]["w"]))
    print(f"model saved (paper JSON+base64 format, bit-exact): {args.out}")


if __name__ == "__main__":
    main()
