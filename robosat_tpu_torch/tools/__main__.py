"""`python -m robosat_tpu_torch.tools <tool>`: the port's command line.

The 15 tools keep the flags and the output contracts of their `rs`
counterparts (robosat_tpu/tools/), in the reference's order: the data
tools `extract`, `cover`, `download` and `rasterize`; `train`, `export`,
`predict`, `masks`, `features`, `merge` and `dedupe`; `serve`; then
`weights`, `compare` and `subset`. `export` writes a torch.export program
(`pt2`) where the JAX tool writes StableHLO. `download` and `serve` need
the `requests` package, which they import when they run; the others load
without it.
"""

import argparse

from robosat_tpu_torch.tools import (
    compare,
    cover,
    dedupe,
    download,
    export,
    extract,
    features,
    masks,
    merge,
    predict,
    rasterize,
    serve,
    subset,
    train,
    weights,
)

# Data prep -> ML -> post-processing -> serving -> utilities.
TOOLS = (extract, cover, download, rasterize, train, export, predict, masks, features, merge, dedupe, serve, weights,
         compare, subset)


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
