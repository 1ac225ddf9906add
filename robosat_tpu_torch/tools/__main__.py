"""`python -m robosat_tpu_torch.tools <tool>`: the port's command line.

The ported tools keep the flags and the output contracts of their `rs`
counterparts (robosat_tpu/tools/), in the reference's order: the data
tools `extract`, `cover`, `download` and `rasterize`; `train`, `predict`,
`masks`, `features`, `merge` and `dedupe`; then `weights`, `compare` and
`subset`. `download` needs the `requests` package, which it imports when it
runs; the others load without it.
"""

import argparse

from robosat_tpu_torch.tools import (
    compare,
    cover,
    dedupe,
    download,
    extract,
    features,
    masks,
    merge,
    predict,
    rasterize,
    subset,
    train,
    weights,
)

# Data prep -> ML -> post-processing -> utilities.
TOOLS = (extract, cover, download, rasterize, train, predict, masks, features, merge, dedupe, weights, compare, subset)


def main():
    parser = argparse.ArgumentParser(prog="python -m robosat_tpu_torch.tools")
    subparser = parser.add_subparsers(title="robosat-tpu-torch tools", metavar="")
    for tool in TOOLS:
        tool.add_parser(subparser)
    subparser.required = True
    args = parser.parse_args()
    args.func(args)


if __name__ == "__main__":
    main()
