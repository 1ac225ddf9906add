"""`python -m robosat_tpu_torch.tools <tool>`: the port's command line.

Only `predict` is ported so far; it keeps the flags and the output
contract of `rs predict` (robosat_tpu/tools/predict.py).
"""

import argparse

from robosat_tpu_torch.tools import predict

TOOLS = (predict,)


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
