def step(sim, tel, registry):
    if tel.enabled:
        from repro_torch.telemetry import learning
        tel.span("round", t0=0.0, t1=1.0)
        learning.LearningRecorder
    if not tel.enabled:
        return sim
    registry.counter("dispatches").inc()
    sim.tel.flush()
    return sim
