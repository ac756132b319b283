"""Trace-driven client-population simulation for the async FL engine."""
from repro_torch.sim.population import (DEFAULT_CLASSES, ClientPopulation,
                                        DeviceClass)
from repro_torch.sim.source import (ParitySource, PopulationSource,
                                    TraceSource, make_class_spec_fn)

__all__ = ["ClientPopulation", "DeviceClass", "DEFAULT_CLASSES",
           "ParitySource", "TraceSource", "PopulationSource",
           "make_class_spec_fn"]
