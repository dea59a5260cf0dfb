"""Interactive read-pair aligner demo (the equivalent of
gobwa_example/main.go): the port of tools/align_repl.py, on the port's host
``AlignmentEngine`` and ``cli.load_reference``.

Reads two sequences a round from stdin and prints every candidate
alignment of each (contig, offset, strand, score, read span), like the
reference REPL (gobwa_example/main.go:16-60).

    python -m lariat_tpu_torch.tools.align_repl <genome.fa or index prefix>
"""

from __future__ import annotations

import sys

from ..align.engine import AlignmentEngine
from ..cli import load_reference


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("usage: python -m lariat_tpu_torch.tools.align_repl "
              "<genome.fa>")
        return 1
    print(f"Loading reference {args[0]} ...")
    engine = AlignmentEngine(load_reference(args[0]))
    print("Ready. Enter read1 then read2 (empty line to quit).")
    while True:
        try:
            r1 = input("read1> ").strip().upper()
            if not r1:
                return 0
            r2 = input("read2> ").strip().upper()
        except EOFError:
            return 0
        ea1, ea2 = engine.align_pair(r1.encode(), r2.encode(), score_delta=25)
        for label, eas in (("read1", ea1), ("read2", ea2)):
            print(f"{label}: {len(eas)} candidates")
            for ea in eas:
                strand = "-" if ea.reversed_ else "+"
                print(f"  {ea.contig}:{ea.offset}{strand} score={ea.score} "
                      f"readspan=[{ea.read_s},{ea.read_e})")


if __name__ == "__main__":
    sys.exit(main())
