"""The port's counterparts of ``examples/*.py``: the reference's workflows
on the card. Each runs as ``python -m gpx_torch.examples.<name>`` with the
subcommands and positional arguments of its counterpart, plus
``--device`` (default: the card; without one it raises) and
``--no-plots``; each writes into ``gpx_torch/examples/output/`` and its
``main`` returns the main outputs as a dict."""
