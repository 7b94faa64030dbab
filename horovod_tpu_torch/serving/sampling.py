"""Token sampling for the decode loop, per-row policy.

Temperature 0 (or below) is exact argmax — the reproducibility contract:
KV-cached greedy decoding matches the no-cache forward token for token,
and the port's greedy tokens match the JAX engine's. A positive
temperature draws from softmax(logits / T) with an explicit
``torch.Generator``; those draws are the port's own and are not meant
to equal the JAX package's (a different generator).
"""

import numpy as np
import torch


def sample_tokens(logits, temperature, generator=None):
    """Next token per row, on logits' device.

    logits       [batch, vocab], any float dtype (upcast to fp32)
    temperature  [batch] host values (numpy or a CPU tensor); <= 0
                 selects argmax for that row. Kept on the host so an
                 all-greedy batch never waits on the device to decide.
    generator    a ``torch.Generator`` on logits' device, used only when
                 some row samples
    """
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temperature, dtype=np.float32)
    if not (temps > 0.0).any():
        return greedy
    t = torch.from_numpy(temps).to(logits.device)
    probs = torch.softmax(logits / torch.clamp(t, min=1e-6)[:, None], dim=-1)
    drawn = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(t > 0.0, drawn, greedy)
