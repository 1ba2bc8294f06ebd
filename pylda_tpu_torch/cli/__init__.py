"""The reference's command-line contract on the PyTorch port.

    python -m pylda_tpu_torch.cli.train --input_directory=... --output_directory=... --number_of_topics=10
    python -m pylda_tpu_torch.cli.test --model=<run-dir>/model-<N> --input_directory=...
    python -m pylda_tpu_torch.cli.infer --model=<run-dir>/model-<N> < docs.txt

The same flags, defaults and outputs as ``pylda_tpu.cli`` (``pylda-train``,
``pylda-test``, ``pylda-infer``), plus ``--device`` (the CUDA card by
default; ``cpu`` runs the plain PyTorch versions).  Flags whose machinery
is not ported yet exit with a message naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def refuse_unported(args, table: Sequence[Tuple[str, str, str]]) -> None:
    """Exit when a flag of ``table`` — (attribute, flag, ROADMAP item) —
    was given: set to a value, or True for a switch."""
    for attr, flag, item in table:
        value = getattr(args, attr)
        if value is not None and value is not False:
            raise SystemExit(
                f"{flag} is not ported to pylda_tpu_torch yet "
                f"(ROADMAP.md {item})"
            )
