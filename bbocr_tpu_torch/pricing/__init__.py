"""Book pricing: provider fan-out, offer parsing, best-offer selection.

Counterpart of ``bbocr_tpu/pricing/``. Importing it needs no HTTP library:
the providers import ``httpx`` when a lookup reaches the network.
"""

from bbocr_tpu_torch.pricing.aggregator import DEFAULT_PROVIDERS, aggregate_offers

__all__ = ["DEFAULT_PROVIDERS", "aggregate_offers"]
