"""repro_torch.analysis — program contracts for the port's round programs.

The port's counterpart of ``repro.analysis``, restated in torch terms: the
reference measures compiled HLO and traced jaxprs; the port runs eagerly,
so every measurement is taken on a run of the program (see ``README`` of
the reference's package for the contracts themselves).

  * ``comms`` / ``dispatch`` / ``memory`` — what a run did: the
    collectives each rank issued (typed ``CollectiveOp`` records with the
    line that issued them), the aten ops it executed (row reads by site,
    sorts, gathers, scatters, the storages it wrote) and its peak live
    bytes;
  * ``blame`` — collective-to-source attribution;
  * ``contracts`` — declarative ``Contract`` objects that programs
    declare next to their code and ``check`` evaluates;
  * ``passes`` / ``lint`` — run-time checks (in-place results, pool
    auditing and hygiene) and the port's source lints;
  * ``programs`` — the canonical program set and its fixture.

CLI: ``python -m repro_torch.analysis check [--device cpu|cuda]`` (run the
canonical program set on two 4-rank meshes and print the contract table)
and ``python -m repro_torch.analysis lint [paths]``.
"""
from repro_torch.analysis import (blame, comms, dispatch,  # noqa: F401
                                  lint, memory, passes)
from repro_torch.analysis.contracts import (Bound, Contract,  # noqa: F401
                                            Report, format_table)
