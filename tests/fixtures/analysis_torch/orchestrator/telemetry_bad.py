from repro_torch.telemetry import learning


def step(sim, tel, registry):
    tel.span("round", t0=0.0, t1=1.0)
    registry.counter("dispatches").inc()
    sim.tel.flush()
    return learning
