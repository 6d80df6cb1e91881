"""Discrete-event federated-learning orchestrator.

``events``       deterministic heap-based discrete-event engine; client
                 completion times come from the ``sysmodel`` latency and
                 energy models, so seeded runs replay identical traces.
``policies``     the sync, semisync and fedbuff arrival/aggregation
                 policies behind one interface.
``client_pool``  batched client execution: one ``torch.func.vmap`` call
                 per width bucket and step.
``runner``       the run loop ``train/fl_loop.run_fl`` delegates to.
"""
from repro_torch.orchestrator.events import Event, EventQueue
from repro_torch.orchestrator.policies import (OrchestratorConfig,
                                               make_policy,
                                               staleness_scaled_weights)
from repro_torch.orchestrator.runner import run_orchestrated

__all__ = ["Event", "EventQueue", "OrchestratorConfig", "make_policy",
           "staleness_scaled_weights", "run_orchestrated"]
