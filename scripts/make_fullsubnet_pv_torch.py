"""Write a FullSubNet model file with seeded random weights.

Usage:
    python scripts/make_fullsubnet_pv_torch.py [--out FILE]

(``FILE`` defaults to ``models/fullsubnet/fullsubnet_random.pv``: a folder of
its own, since every ``models/*.pv`` is a file of the JAX package's model.)

FullSubNet at the widths of the recipe
``recipes/dns_interspeech_2020/fullsubnet/train.toml``
(https://github.com/Audio-WestlakeU/FullSubNet): a full-band LSTM 257-512-512
with a ReLU output layer, a sub-band LSTM 32-384-384 shared by the 257 bins,
a complex ratio mask (K 10, limit 9.9), bf16 products. The weights are
``models/fullsubnet.py``'s ``init_params`` (PyTorch's default LSTM and
Linear initialisation) from the generator seed ``SEED``, and the file holds
them as float16 (the ``.pv`` container), about 11 MB. The same seed gives the
same bytes. The trained checkpoint is not in the repository; these weights
make no claim on quality.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from koala_tpu_torch.models import fullsubnet, params_io  # noqa: E402

SEED = 20210524
OUT = os.path.join(ROOT, "models", "fullsubnet", "fullsubnet_random.pv")
CONFIG = dict(fullsubnet.DEFAULT_CONFIG)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    params = fullsubnet.init_params(torch.Generator().manual_seed(SEED), CONFIG)
    params_io.save_params(args.out, params, CONFIG)
    print("%s: %d parameters, %d bytes" % (args.out, fullsubnet.num_params(params),
                                          os.path.getsize(args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
