"""The LIRA examples on the port: ``python -m repro_torch.examples.<name>``
runs one on the card, ``--device cpu`` on the CPU."""
