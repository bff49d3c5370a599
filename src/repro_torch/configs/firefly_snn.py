"""firefly-snn — the paper's own model (Sec. IV-A).

Three-layer fully-connected plastic SNN: 128 hidden neurons for continuous
control, 1024 for the MNIST online-learning task (784-1024-10, Table II):
the networks the FireFly-P accelerator runs."""
from repro_torch.core.snn import SNNConfig

# continuous control (obs/act dims follow the 8-dim direction task)
CONFIG = SNNConfig(
    layer_sizes=(8, 128, 8), timesteps=4, trace_decay=0.8, plastic=True)

# MNIST online-learning variant (Table II: 784-1024-10)
MNIST = SNNConfig(
    layer_sizes=(784, 1024, 10), timesteps=8, trace_decay=0.8,
    spiking_readout=True, plastic=True)

SMOKE = SNNConfig(
    layer_sizes=(8, 32, 4), timesteps=2, trace_decay=0.8, plastic=True)
