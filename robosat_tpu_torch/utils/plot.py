"""Training-history plotting (per-epoch metric curves to a PNG).

Counterpart of robosat_tpu/utils/plot.py (the reference's
robosat/utils.py:7-22): one chart, one line per tracked metric, epoch
numbers on the x axis. matplotlib is imported inside `plot`, so the port
loads without it; `plot` raises ImportError where it is missing, and the
train tool then logs that the chart was not written.
"""


def plot(out, history):
    """Render every metric series in `history` (name -> values) into `out`."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot

    fig, ax = pyplot.subplots()

    epochs = max((len(series) for series in history.values()), default=0)
    ax.set_xticks(range(epochs), labels=[str(e + 1) for e in range(epochs)])
    ax.set_xlabel("epoch")
    ax.grid(True)

    for name, series in history.items():
        ax.plot(series, label=name)

    if history:
        ax.legend()

    fig.savefig(out, format="png")
    pyplot.close(fig)
