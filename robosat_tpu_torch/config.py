"""TOML configuration handling.

Counterpart of robosat_tpu/config.py: the two-TOML config shape (model
config with [common]/[opt]; dataset config with [common]/[weights]) read
with the stdlib ``tomllib``, and a minimal writer for the value types these
configs use. The model config's ``cuda`` key selects the GPU
(robosat_tpu_torch/device.py).
"""

import tomllib


def load_config(path):
    """Load a configuration dictionary from a TOML file."""
    with open(path, "rb") as fp:
        return tomllib.load(fp)


def _format_value(value):
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        escaped = value.replace("\\", "\\\\").replace('"', '\\"')
        return '"{}"'.format(escaped)
    if isinstance(value, (list, tuple)):
        return "[{}]".format(", ".join(_format_value(v) for v in value))
    raise TypeError("unsupported TOML value type: {}".format(type(value)))


def dumps_config(attrs):
    """Serialize a (possibly nested one level) dict to a TOML string."""
    lines = []
    tables = []
    for key, value in attrs.items():
        if isinstance(value, dict):
            tables.append((key, value))
        else:
            lines.append("{} = {}".format(key, _format_value(value)))
    for name, table in tables:
        if lines and lines[-1] != "":
            lines.append("")
        lines.append("[{}]".format(name))
        for key, value in table.items():
            lines.append("{} = {}".format(key, _format_value(value)))
    return "\n".join(lines) + "\n"


def save_config(attrs, path):
    """Save a configuration dictionary to a TOML file."""
    with open(path, "w") as fp:
        fp.write(dumps_config(attrs))
