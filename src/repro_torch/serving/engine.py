"""Batched generation engine: prefill + greedy/temperature decode (the port of
``repro/serving/engine.py``), in eager PyTorch: nothing is compiled.

Two batching disciplines share one model and one decode computation:

* :meth:`Engine.generate` — the **static batch**: requests are padded into
  one lockstep batch; ragged prompts are right-padded and each row's first
  token is sampled from its own last real prompt token (see
  ``transformer.prefill``'s ``last_positions``); rows that emit ``eos_id``
  keep decoding into a waste slot and their waste tokens are masked out.
* :meth:`Engine.slots` — **continuous batching**: a fixed pool of slots over
  one persistent batched KV cache with *per-slot positions*.
  :meth:`SlotPool.admit` prefills one prompt into a free slot (batch-1
  prefill, cache rows written in place), :meth:`SlotPool.step` decodes every
  slot at its own depth in one lockstep step, and :meth:`SlotPool.evict`
  frees a slot the moment its row finishes.

Known approximation (static batch only, as in the JAX package): after
prefill, decode steps use one shared position counter for the whole batch,
so a short row's later tokens sit at the padded batch's positions, and its
KV slots between ``len(prompt)`` and the batch's ``max_len`` hold pad-token
entries. The slot pool does not share this.

:meth:`Engine.lower_prefill` and :meth:`Engine.lower_decode` hand the
serving cost probe one step at a cell and its inputs. The JAX package
returns a jit-lowered computation; the port, which serves eagerly, returns
the eager step itself, which the probe records
(``core.hlo_analysis.record_ops``), prices and times.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.config import Runtime


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray          # [B, max_new]; waste slots masked to eos_id
    prompt_lens: np.ndarray
    steps: int                  # decode steps actually run (early-exit aware)
    finished_steps: np.ndarray | None = None  # per-row eos step, -1 = never
    # host clock: from the call to the first tokens on the host (the prefill
    # and the first sample), and from there to the last tokens on the host
    prefill_s: float = 0.0
    decode_s: float = 0.0


class Engine:
    def __init__(self, model: transformer.LM, rt: Runtime, *, max_len: int = 512):
        self.model = model
        self.cfg = model.cfg
        self.rt = rt
        self.max_len = max_len
        self.device = model.embed.device

    def _prefill(self, tokens: torch.Tensor, last: torch.Tensor):
        return transformer.prefill(self.model, self.rt, tokens=tokens, last_positions=last)

    def _decode(self, cache, tokens: torch.Tensor, pos):
        return transformer.decode_step(self.model, cache, tokens, pos, self.rt)

    def generate(self, prompts: list[list[int]], *, max_new: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: int | None = None) -> GenerateResult:
        b = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int64)
        plen = int(lens.max())
        toks = np.zeros((b, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p    # right-padded; per-row gather below
        t0 = time.perf_counter()
        logits, cache = self._prefill(torch.from_numpy(toks).to(self.device),
                                      torch.from_numpy(lens - 1).to(self.device))
        cache = transformer.pad_cache(cache, self.cfg, plen + max_new)
        gen = torch.Generator(device=logits.device).manual_seed(seed)
        out = np.zeros((b, max_new), np.int32)
        finished = np.full((b,), -1, np.int32)
        tok = _sample(logits, temperature, gen)
        steps = 0
        t1 = t0
        for step in range(max_new):
            t = tok[:, 0].cpu().numpy()
            if step == 0:
                t1 = time.perf_counter()
            out[:, step] = t
            steps = step + 1
            if eos_id is not None:
                finished = np.where((t == eos_id) & (finished < 0), step, finished)
            if step == max_new - 1:
                break
            if eos_id is not None and (finished >= 0).all():
                break               # every row done: stop burning waste slots
            logits, cache = self._decode(cache, tok, plen + step)
            tok = _sample(logits, temperature, gen)
        t2 = time.perf_counter()
        if eos_id is not None:
            # waste-slot masking: a finished row keeps decoding in the static
            # batch; everything after its eos is noise, not output
            col = np.arange(max_new)[None, :]
            done = finished[:, None]
            out = np.where((done >= 0) & (col > done), eos_id, out)
        return GenerateResult(tokens=out, prompt_lens=lens.astype(np.int32), steps=steps,
                              finished_steps=finished if eos_id is not None else None,
                              prefill_s=t1 - t0, decode_s=t2 - t1)

    # ---------------------------------------------------- characterization
    def lower_prefill(self, batch: int, prompt_len: int):
        """The prefill step at one ``(batch, prompt_len)`` cell: returns
        ``(step, args)``, the callable and the tensors on the engine's device
        to run it with (tokens ``arange(B·L) % vocab``, each row's last
        position ``L - 1``)."""
        toks = (torch.arange(batch * prompt_len, device=self.device)
                % max(self.cfg.vocab_size, 1)).reshape(batch, prompt_len)
        last = torch.full((batch,), prompt_len - 1, dtype=torch.long, device=self.device)
        return self._prefill, (toks, last)

    def lower_decode(self, batch: int, prompt_len: int, max_len: int | None = None):
        """One decode step at a cell: a cache of ``max_len`` positions (the
        engine's own ``max_len`` by default, the cache the serving loop
        decodes against), written at position ``prompt_len`` (the first
        generated token's step). Returns ``(step, args)``; ``step(*args)``
        can run again and again on the same cache, which it consumes
        nothing of: it writes the same K and V at the same position and
        hands the Mamba states back as new tensors (the JAX package's
        non-donating jit)."""
        max_len = max_len if max_len is not None else self.max_len
        cache = transformer.init_cache(self.model, batch, max_len, self.cfg.cdtype)
        toks = torch.zeros((batch, 1), dtype=torch.long, device=self.device)

        def step(cache, tokens):
            return self._decode(cache, tokens, prompt_len)

        return step, (cache, toks)

    # ------------------------------------------------------- slot-level API
    def slots(self, n_slots: int, *, max_len: int | None = None) -> "SlotPool":
        """A continuous-batching slot pool over this engine's model."""
        return SlotPool(self, n_slots,
                        max_len=max_len if max_len is not None else self.max_len)


def _sample(logits: torch.Tensor, temperature: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """[B,V] logits -> [B,1] tokens: the argmax (the first of equal maxima)
    when ``temperature <= 0``, else a draw from softmax(logits / T)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)[:, None]
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


@dataclasses.dataclass
class _Slot:
    """Book-keeping for one row of the pool's persistent batch."""

    uid: int = -1                 # caller-supplied request id, -1 = free
    pos: int = 0                  # next KV write index == current kv_len
    n_generated: int = 0
    active: bool = False


class SlotPool:
    """Continuous batching over one persistent batched KV cache.

    The pool owns one cache of ``n_slots`` rows of ``max_len`` positions and
    a per-slot position. :meth:`admit` runs a batch-1 prefill for one prompt
    and copies its cache into the slot's rows in place (the other slots'
    rows are untouched); :meth:`step` runs **one** lockstep decode step for
    the whole pool with per-slot positions; :meth:`evict` frees the slot
    immediately — its stale KV rows are masked by the per-slot ``kv_len``
    and overwritten by the next admission.

    Free slots still occupy their row of the batch; their garbage tokens are
    never surfaced. Greedy decoding is deterministic per slot whatever the
    other slots hold; ``temperature > 0`` draws each slot's token from a
    generator seeded by ``(seed, uid, n_generated)``, so a request's sample
    path does not depend on which slot it landed in or what was co-batched.
    """

    def __init__(self, engine: Engine, n_slots: int, *, max_len: int,
                 temperature: float = 0.0, seed: int = 0):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.engine = engine
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.cache = transformer.init_cache(engine.model, self.n_slots, self.max_len,
                                            engine.cfg.cdtype)
        self._slots = [_Slot() for _ in range(self.n_slots)]
        self._tok = np.zeros((self.n_slots, 1), np.int64)  # last sampled token

    # ------------------------------------------------------------- queries
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if not s.active]

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s.active]

    def position(self, slot: int) -> int:
        return self._slots[slot].pos

    # ------------------------------------------------------------ lifecycle
    def admit(self, slot: int, prompt: list[int], *, uid: int = 0, max_new: int = 1) -> int:
        """Prefill ``prompt`` into a free ``slot``; returns the first token.

        ``max_new`` is only validated here (the scheduler enforces the
        budget); the prompt plus budget must fit the pool's ``max_len``.
        """
        st = self._slots[slot]
        if st.active:
            raise ValueError(f"slot {slot} is occupied (uid={st.uid})")
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds the "
                f"pool's max_len ({self.max_len})")
        eng = self.engine
        toks = torch.tensor([prompt], dtype=torch.long, device=eng.device)
        last = torch.tensor([len(prompt) - 1], dtype=torch.long, device=eng.device)
        logits, pc = eng._prefill(toks, last)
        for big_p, small_p in zip(self.cache, pc):
            for layer, small_c in small_p.items():
                for name, small in small_c.items():
                    big = big_p[layer][name]
                    region = (slot,) + tuple(slice(0, n) for n in small.shape[1:])
                    big[region] = small[0].to(big.dtype)
        st.uid, st.pos, st.n_generated, st.active = uid, len(prompt), 0, True
        tok = int(self._sample_slot(logits, st))
        self._tok[slot, 0] = tok
        # pos stays at len(prompt): the first generated token's KV is written
        # by the *next* decode step, at exactly that position
        st.n_generated = 1
        return tok

    def evict(self, slot: int) -> None:
        """Free ``slot`` immediately; its KV rows stay as invisible garbage
        (masked by per-slot kv_len) until the next admission overwrites them."""
        self._slots[slot] = _Slot()

    def step(self) -> np.ndarray:
        """One lockstep decode step for the whole pool; returns ``[n_slots]``
        tokens. Only the active slots' tokens are meaningful."""
        if not any(s.active for s in self._slots):
            raise ValueError("step() with no active slot")
        eng = self.engine
        pos = torch.tensor([s.pos for s in self._slots], dtype=torch.long, device=eng.device)
        logits, self.cache = eng._decode(self.cache, torch.from_numpy(self._tok).to(eng.device),
                                         pos)
        out = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        if self.temperature > 0.0:
            # sample only the occupied rows: free slots keep their greedy
            # garbage (never surfaced)
            for i, st in enumerate(self._slots):
                if st.active:
                    out[i] = self._sample_slot(logits[i:i + 1], st)
        for i, st in enumerate(self._slots):
            self._tok[i, 0] = out[i]
            if st.active:
                st.pos += 1
                st.n_generated += 1
        return out

    # ------------------------------------------------------------- sampling
    def _slot_generator(self, st: _Slot) -> torch.Generator:
        # uid folded mod 2^32: callers may use negative sentinel uids
        seq = np.random.SeedSequence([self.seed, st.uid % (1 << 32), st.n_generated])
        return torch.Generator().manual_seed(int(seq.generate_state(1)[0]))

    def _sample_slot(self, logits: torch.Tensor, st: _Slot) -> int:
        gen = self._slot_generator(st) if self.temperature > 0 else None
        return int(_sample(logits.cpu(), self.temperature, gen)[0, 0])
