from repro_torch.data.poisson import PoissonSampler
from repro_torch.data.synthetic import ImageClassDataset, TokenDataset

__all__ = ["ImageClassDataset", "PoissonSampler", "TokenDataset"]
