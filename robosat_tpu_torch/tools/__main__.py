"""`python -m robosat_tpu_torch.tools <tool>`: the port's command line.

The ported tools, `train`, `predict`, `masks`, `features`, `merge` and
`dedupe`, keep the flags and the output contracts of their `rs`
counterparts (robosat_tpu/tools/).
"""

import argparse

from robosat_tpu_torch.tools import dedupe, features, masks, merge, predict, train

TOOLS = (train, predict, masks, features, merge, dedupe)


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
