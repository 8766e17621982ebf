from repro_torch.data.poisson import PoissonSampler
from repro_torch.data.synthetic import ImageClassDataset

__all__ = ["ImageClassDataset", "PoissonSampler"]
