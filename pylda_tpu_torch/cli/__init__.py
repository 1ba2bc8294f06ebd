"""The reference's command-line contract on the PyTorch port.

    python -m pylda_tpu_torch.cli.train --input_directory=... --output_directory=... --number_of_topics=10
    python -m pylda_tpu_torch.cli.test --model=<run-dir>/model-<N> --input_directory=...
    python -m pylda_tpu_torch.cli.infer --model=<run-dir>/model-<N> < docs.txt

The same flags, defaults and outputs as ``pylda_tpu.cli`` (``pylda-train``,
``pylda-test``, ``pylda-infer``), plus ``--device`` (the CUDA card by
default; ``cpu`` runs the plain PyTorch versions).
"""

