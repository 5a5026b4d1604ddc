"""repro_torch.data — the synthetic social-data stream and the LM token
stream (counterpart of `repro.data`)."""
from repro_torch.data.social import SocialStream, make_social_stream
from repro_torch.data.lm import TokenStream, lm_batches

__all__ = ["SocialStream", "make_social_stream", "TokenStream", "lm_batches"]
