"""The cold-start FaaS runtime of the port: image build (``deploy``), the
staged boot pipeline (``boot``, ``drivers``), the executor, and the control
plane in front of them (``gateway`` -> ``dispatcher`` -> ``agent`` over a
``cluster`` of hosts with tiered caches), with request coalescing
(``batching``) and forecast-driven pre-boot (``forecast``).

    from repro_torch.core import FunctionSpec, Gateway
    gw = Gateway(n_hosts=2, mode="cold")           # device="cpu" off the GPU
    gw.deploy(spec)
    gw.invoke(spec.name)
"""
from repro_torch.core.artifact import FunctionSpec
from repro_torch.core.batching import BatchingConfig
from repro_torch.core.forecast import ForecastConfig
from repro_torch.core.gateway import Gateway

__all__ = ["BatchingConfig", "ForecastConfig", "FunctionSpec", "Gateway"]
