"""repro_torch.data — the synthetic social-data stream (counterpart of
`repro.data`; its LM token stream waits for ROADMAP queue 1 item 5)."""
from repro_torch.data.social import SocialStream, make_social_stream

__all__ = ["SocialStream", "make_social_stream"]
