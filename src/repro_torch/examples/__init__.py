"""The reference's four examples on the port, as modules of the package.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.fleet_scheduler
    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.train_carbon_aware

Each takes the reference example's flags and defaults, plus ``--device``
(None, the default, is the card: without a GPU the example raises;
``--device cpu`` runs the port's plain PyTorch path on the CPU). Each
prints the reference's lines and returns them, with the values they show,
as a dict. ``main(argv)`` parses the flags and calls ``run(args, ...)``,
which also takes the model or initial state to start from.
"""
