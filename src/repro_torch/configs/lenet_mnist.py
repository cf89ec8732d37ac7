"""The paper's own experiment config: LeNet-5-style CNN on (synthetic)
MNIST, 20-node 8-regular DFL, 2 Byzantine nodes (Section V-A).  Port of
``repro.configs.lenet_mnist.PaperDFLConfig``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperDFLConfig:
    """Section V-A validation scenario."""

    n_nodes: int = 20
    degree: int = 8
    n_malicious: int = 2
    rounds: int = 10
    local_epochs: int = 1
    lr: float = 0.01
    momentum: float = 0.9
    batch_size: int = 64
    # aggregation hyper-parameters
    f: int = 2
    trim_beta: float = 0.1
    multi_krum_m_frac: float = 0.25
    tau1: float = 0.4
    tau2: float = 0.4
    tau3: float = 0.2
    alpha: float = 0.8
    window: int = 3
    transient: int = 3


PAPER_DFL = PaperDFLConfig()
