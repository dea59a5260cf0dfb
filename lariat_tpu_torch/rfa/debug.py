"""Debug switches: reference ``-debugPrintMove`` move-by-move dumps.

The reference prints diagnostics from inside fastScore / the MAPQ pass when
the flag is set (lariat.go:876, 1189-1304). Set PRINT_MOVE before worker
processes fork (the CLI does) so every worker inherits it.
"""

PRINT_MOVE = False

# reference ``-debug`` (main.go:17): gates the per-alignment molecule-move
# diagnostic strings built by debugStrings (lariat.go:994-1046) that flow
# into the AA bam tag via mapq_data.active_alignments_in_molecules.
DEBUG = False
