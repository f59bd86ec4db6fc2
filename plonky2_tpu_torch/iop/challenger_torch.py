"""The Fiat-Shamir challenger on the device: the duplex sponge's values in
one buffer on the card, its lengths on the host.

The port's counterpart of plonky2_tpu/iop/challenger_jax.py:
DeviceChallenger, with the host challenger's buffering (iop/challenger.py):
overwrite-mode absorption, outputs popped from the END, every observation
clearing the outputs.  The transcript's shape is known on the host, so the
lengths of the pending inputs and of the outputs stay host-side Python
state; only the values live on the device, in one buffer of 20 words (the
12 state words, then 8 pending-input slots; the outputs are always the
state's first words, as the host challenger's are).

Observations are queued; each draw launches kernel K9
(hash/poseidon_cuda.py:sponge_cuda) once for the queued observations and
the draws together, and returns device tensors, so no value crosses to the
host.  On a CPU device every launch runs K9's plain version.  ``grind``
runs the proof-of-work grind (K8) on the sponge's state and leaves its
witness in the next pending-input slot, observed.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import lies_on, resolve_device
from ..field.convert import from_u64, to_u64
from ..hash import poseidon as pos
from ..hash import poseidon_cuda as pc


def _upload(words, device: torch.device) -> torch.Tensor:
    """Host words -> an int64 tensor on `device`; to a card through pinned
    memory without waiting."""
    host = from_u64(np.asarray(words, dtype=np.uint64).reshape(-1))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class DeviceChallenger:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.buf = torch.zeros(pc.SPONGE_WORDS, dtype=torch.int64,
                               device=self.device)
        self.n_in = 0       # pending inputs
        self.n_out = 0      # outputs left: the state's first n_out words
        self._queue = []    # (rows, cols) tensors to absorb, in order

    @classmethod
    def from_host(cls, host, device=None) -> "DeviceChallenger":
        """Seed from a host Challenger mid-transcript (state and buffers)."""
        state = [int(x) for x in host.sponge_state]
        inputs = [int(x) for x in host.input_buffer]
        outputs = [int(x) for x in host.output_buffer]
        if outputs != state[:len(outputs)]:
            raise ValueError("the host challenger's outputs are not its "
                             "state's first words")
        ch = cls.__new__(cls)
        ch.device = resolve_device(device)
        ch.buf = _upload(state + inputs + [0] * (pos.SPONGE_RATE
                                                 - len(inputs)), ch.device)
        ch.n_in, ch.n_out, ch._queue = len(inputs), len(outputs), []
        return ch

    def sync_host(self, host) -> None:
        """Write this challenger's values into a host Challenger, so the
        transcript can go on there (one download)."""
        self.flush()
        words = [int(x) for x in to_u64(self.buf)]
        host.sponge_state = words[:pos.WIDTH]
        host.input_buffer = words[pos.WIDTH:pos.WIDTH + self.n_in]
        host.output_buffer = words[:self.n_out]

    # -- observations (queued until the next launch) ----------------------

    def _words(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            if not lies_on(x, self.device):
                raise ValueError(f"observed values on {x.device}, the "
                                 f"challenger on {self.device}")
            return x
        return _upload(x, self.device)

    def observe_element(self, element) -> None:
        self.observe_elements_array(self._words(element).reshape(1))

    def observe_elements(self, elements) -> None:
        self.observe_elements_array(self._words(elements))

    def observe_elements_array(self, elements) -> None:
        """K elements, in order (one bulk absorb)."""
        words = self._words(elements).reshape(1, -1)
        if words.shape[1]:
            self._queue.append(words)

    def observe_extension_elements(self, coords) -> None:
        """Extension elements given as their (2, m) coordinates (rows c0
        and c1), observed element by element (c0, c1 of each), as the host
        challenger's ``observe_extension_elements`` of the (m, 2) array."""
        coords = self._words(coords)
        if coords.dim() != 2 or coords.shape[0] != 2:
            raise ValueError(f"expected (2, m) coordinates, got "
                             f"{tuple(coords.shape)}")
        if coords.shape[1]:
            self._queue.append(coords)

    def observe_cap_array(self, cap) -> None:
        """A (4, 2^h) level of digests (a tree's top, column-major),
        observed digest by digest as the host challenger's ``observe_cap``
        of its (2^h, 4) cap."""
        cap = self._words(cap)
        if cap.dim() != 2 or cap.shape[0] != 4:
            raise ValueError(f"expected (4, k) digests, got "
                             f"{tuple(cap.shape)}")
        self._queue.append(cap)

    # -- draws ------------------------------------------------------------

    def get_challenge(self) -> torch.Tensor:
        """A 0-d tensor."""
        return self._launch(1)[0][0]

    def get_n_challenges(self, n: int, index_mask: int = 0):
        """(n,) tensor; with index_mask, also each challenge & index_mask
        (query indices below a power of two): (challenges, indices)."""
        draws, idx, _ = self._launch(n, index_mask=index_mask)
        return (draws, idx) if index_mask else draws

    def get_extension_challenge(self, powers: int = 0):
        """(2,) tensor (c0, c1); with powers = k, also its powers 1, beta,
        ..., beta^(k - 1) as (2, k) coordinates: (beta, powers)."""
        draws, _, pw = self._launch(2, arity=powers)
        return (draws, pw) if powers else draws

    # -- the grind and the launches ----------------------------------------

    def grind(self, bits: int) -> torch.Tensor:
        """The smallest proof-of-work witness for the state the next
        duplexing permutes (K8), observed: it lands in the next pending
        slot on the device.  Returns it as a (1,) tensor."""
        self.flush()
        witness = pc.pow_grind_sponge_cuda(self.buf, self.n_in, bits)
        self.n_in += 1
        self.n_out = 0
        return witness

    def flush(self) -> None:
        """Absorb the queued observations now (one launch, no draw)."""
        if self._queue or self.n_in == pos.SPONGE_RATE:
            self._launch(0)

    def _launch(self, n_draws: int, index_mask: int = 0, arity: int = 0):
        queue, self._queue = self._queue, []
        if len(queue) > 1:      # one source in element order
            src = torch.cat([q.T.reshape(-1) for q in queue]).view(1, -1)
        else:
            src = queue[0] if queue else None
        out = pc.sponge_cuda(self.buf, self.n_in, self.n_out, src, n_draws,
                             index_mask, arity)
        self.n_in, self.n_out, _ = pc.sponge_lengths(
            self.n_in, self.n_out, 0 if src is None else src.numel(),
            n_draws)
        return out
