from repro_torch.data.attacks import ATTACK_NAMES, AttackConfig, generate_attack_stream
from repro_torch.data.pipeline import build_communities, make_split_masks, standardize_features
from repro_torch.data.synth import SynthConfig, generate_event_stream, generate_transactions

__all__ = ["ATTACK_NAMES", "AttackConfig", "SynthConfig", "build_communities",
           "generate_attack_stream", "generate_event_stream", "generate_transactions",
           "make_split_masks", "standardize_features"]
