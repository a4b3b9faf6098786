"""Derived analyses: the energy span model, descriptor-grid triage and
uncertainty quantification."""
from .energy_span import Energy, energy_span_model
from .grid import (FAIL_CONSERVATION, FAIL_RATE, average_neighborhood,
                   classify_failures, convergence_heatmap, make_heatmap)
from .uncertainty import Uncertainty
