"""firefly-snn — the paper's own model (Sec. IV-A).

Three-layer fully-connected plastic SNN controller with 128 hidden neurons
for continuous control: the network the FireFly-P accelerator runs."""
from repro_torch.core.snn import SNNConfig

# continuous control (obs/act dims follow the 8-dim direction task)
CONFIG = SNNConfig(
    layer_sizes=(8, 128, 8), timesteps=4, trace_decay=0.8, plastic=True)
