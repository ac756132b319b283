"""Aggregation strategy presets (the tree engine of ``repro.core.fedfa`` is
not ported; the flat engine in ``repro_torch.core.flat`` runs them)."""

STRATEGIES = {
    # paper's method, all three flexibility modes share the same aggregation
    "fedfa": dict(graft=True, scale=True),
    # prior work: partial (incomplete) aggregation, no grafting, no scaling
    "heterofl": dict(graft=False, scale=False),
    "flexifed": dict(graft=False, scale=False),
    "nefl": dict(graft=False, scale=False),
    "fedavg": dict(graft=False, scale=False),
    # ablations
    "fedfa-graft-only": dict(graft=True, scale=False),
    "fedfa-scale-only": dict(graft=False, scale=True),
}
