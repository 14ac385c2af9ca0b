from repro_torch.data.pipeline import build_communities, make_split_masks, standardize_features
from repro_torch.data.synth import SynthConfig, generate_transactions

__all__ = ["SynthConfig", "build_communities", "generate_transactions",
           "make_split_masks", "standardize_features"]
