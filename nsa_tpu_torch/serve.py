"""Continuous-batching serving engine over the structured sparse KV cache,
or the full-attention model's kv cache (``nsa_tpu/serve.py``).

* a fixed pool of cache slots ([max_batch] leading dim on every cache
  leaf), each slot with its own sequence length;
* ragged decode: one step advances every slot at its own position
  (``transformer_decode_step_ragged``: the ragged fused kernel pair per
  layer, or over a paged kv pool);
* exact bucketed prefill: a wave of prompts is right-padded to one of a few
  bucket lengths and prefilled in one call with per-row ``true_len``; the
  cache equals incremental decode's because pad rows are never read and are
  overwritten as decode advances;
* admission and retirement (max tokens, stop byte, cache capacity) between
  steps: new requests join as others finish, without draining the pool;
* ``steps_per_sync`` > 1 decodes that many tokens per host round trip, the
  sampled token fed back on the device, with one [B, steps] readback.

The engine allocates its caches on the params' device, so params on the
card serve on the card.  The full-attention model serves on the dense pool
only; its paged pool raises, as in JAX.  Not ported: the ``mesh`` argument
(serving over a (data, heads) mesh waits for the port's parallelism,
``ROADMAP.md``).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .models.transformer import (
    _check_model,
    _compute_dtype,
    _sample_from_logits,
    fuse_decode_params,
    init_layer_cache,
    transformer_decode_step_ragged,
    transformer_prefill,
)
from .ops.common import round_up_mult
from .ops.nsa import NSADecodeCache, _ckv_width


def ragged_decode_step(params, cfg: ModelConfig, tokens, cache_layers, seq_lens, *,
                       route: Optional[str] = None):
    """Advance every slot one token at its own position: tokens [B], seq_lens
    [B] int tensors on the caches' device.  Returns (logits [B, vocab],
    cache_layers), the caches updated in place.  Inactive slots decode
    garbage into their own row and are ignored by the host."""
    return transformer_decode_step_ragged(params, cfg, tokens, cache_layers, seq_lens,
                                          route=route)


def ragged_decode_multi(params, cfg: ModelConfig, tokens, cache_layers, seq_lens,
                        num_steps: int, temperature: float = 0.0, filter_thres: float = 0.9,
                        generator: Optional[torch.Generator] = None, *, page_table=None,
                        route: Optional[str] = None):
    """Advance every slot ``num_steps`` tokens without a host sync: each
    slot's sampled token and position ``t + 1`` stay on the device and feed
    the next step.  Greedy at ``temperature <= 0``, else top-k + Gumbel
    with noise from ``generator`` (on the caches' device).  Returns (tokens
    [B, num_steps] on the device, cache_layers)."""
    toks, t = [], seq_lens
    for _ in range(num_steps):
        logits, cache_layers = transformer_decode_step_ragged(
            params, cfg, tokens, cache_layers, t, page_table, route=route)
        gumbel = None
        if temperature > 0:
            u = torch.rand(logits.shape, generator=generator, device=logits.device)
            gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        tokens = _sample_from_logits(logits, temperature, filter_thres, gumbel)
        toks.append(tokens)
        t = t + 1
    return torch.stack(toks, dim=1), cache_layers


def ragged_decode_step_paged(params, cfg: ModelConfig, tokens, cache_layers, seq_lens,
                             page_table, *, route: Optional[str] = None):
    """Paged ``ragged_decode_step``: every layer's kv leaf is a page pool
    addressed through ``page_table`` [B, max_pages] int32 (the host remaps
    it between steps only)."""
    return transformer_decode_step_ragged(params, cfg, tokens, cache_layers, seq_lens,
                                          page_table, route=route)


def ragged_decode_multi_paged(params, cfg: ModelConfig, tokens, cache_layers, seq_lens,
                              page_table, num_steps: int, temperature: float = 0.0,
                              filter_thres: float = 0.9,
                              generator: Optional[torch.Generator] = None, *,
                              route: Optional[str] = None):
    """Paged ``ragged_decode_multi``: the page table is the same for all
    ``num_steps``; admission reserves every page a request can touch, so a
    sync window needs no remapping."""
    return ragged_decode_multi(params, cfg, tokens, cache_layers, seq_lens, num_steps,
                               temperature, filter_thres, generator, page_table=page_table,
                               route=route)


def _paged_merge_wave(cache_layers, wave_layers, phys_pages: np.ndarray, slots):
    """Merge a prefill wave into the paged pool and the dense ckv / ring
    slots, in place.

    cache_layers: per-layer caches (kv a pool [P + 1, kvh, PAGE, 2d], ckv
    [B, kvh, Wc, 2d], ring [B, kvh, Bc, 2d]); wave_layers: the wave's
    prefill caches, one row per admitted request (kv [n, kvh, bucket_up,
    2d], ckv [n, kvh, Wc_b, 2d]); phys_pages [n, bucket_up // PAGE] the
    physical page of each logical page, or P + 1 (past the pool) where the
    page lies beyond the row's reservation — those are dropped; slots [n]
    the rows' slots."""
    dev = cache_layers[0].kv.device
    flat = phys_pages.reshape(-1)
    keep = np.nonzero(flat < cache_layers[0].kv.shape[0])[0]
    dst = torch.as_tensor(flat[keep], dtype=torch.long, device=dev)
    src = torch.as_tensor(keep, dtype=torch.long, device=dev)
    slot_idx = torch.as_tensor(np.asarray(slots), dtype=torch.long, device=dev)
    for pool_c, wave in zip(cache_layers, wave_layers):
        _, kvh, page, d2 = pool_c.kv.shape
        n, _, bucket_up, _ = wave.kv.shape
        blocks = wave.kv.reshape(n, kvh, bucket_up // page, page, d2).transpose(1, 2)
        blocks = blocks.reshape(-1, kvh, page, d2)
        pool_c.kv.index_copy_(0, dst, blocks.index_select(0, src).to(pool_c.kv.dtype))
        ckv = torch.zeros((n, *pool_c.ckv.shape[1:]), dtype=pool_c.ckv.dtype, device=dev)
        ckv[:, :, :wave.ckv.shape[2]] = wave.ckv
        pool_c.ckv.index_copy_(0, slot_idx, ckv)
        pool_c.ring.index_copy_(0, slot_idx, wave.ring.to(pool_c.ring.dtype))
    return cache_layers


def bucketed_prefill(params, cfg: ModelConfig, padded_ids, max_len: int, true_len):
    """Prefill a right-padded [1, bucket] prompt with its true length."""
    return transformer_prefill(params, cfg, padded_ids, max_len, true_len=true_len)


def wave_prefill(params, cfg: ModelConfig, padded_ids, max_len: int, true_lens):
    """Prefill a wave of right-padded prompts [n, bucket] with per-row true
    lengths [n] (a tensor on the ids' device).  Returns each row's first
    greedy token (the argmax at its own last real position, on the device)
    and the wave's cache."""
    logits, cache = transformer_prefill(params, cfg, padded_ids, max_len, true_len=true_lens)
    rows = torch.arange(padded_ids.shape[0], device=padded_ids.device)
    first = logits[rows, true_lens.long() - 1].argmax(-1)
    return first.to(torch.int32), cache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    stop_byte: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None


class ContinuousBatchingEngine:
    """Slot-based continuous batching for NSA (or full-attention) decode."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        max_batch: int = 8,
        max_len: int = 1024,
        prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512),
        dtype: Optional[torch.dtype] = None,
        steps_per_sync: int = 1,
        temperature: float = 0.0,
        filter_thres: float = 0.9,
        seed: int = 0,
        mesh=None,
        paged_pool_pages: Optional[int] = None,
        page_tokens: int = 64,
        route: Optional[str] = None,
    ):
        """``dtype`` is the caches' (default: the config's compute dtype).
        ``paged_pool_pages`` switches the kv cache to a shared pool of that
        many usable pages of ``page_tokens`` rows, plus one trash page: kv
        memory then scales with live tokens (prompt + generation,
        page-rounded) instead of max_batch x max_len.  Admission reserves a
        request's whole lifetime of pages, so no request runs out mid-flight;
        when the pool is full, pending requests wait.  ``route`` is the
        ragged step's (``transformer_decode_step_ragged``); the paged pool
        takes the fused route only, and the sparse model only.  Sampling at ``temperature > 0`` draws
        its noise from ``torch.Generator``s seeded with ``seed``."""
        if mesh is not None:
            raise NotImplementedError("serving over a device mesh is not ported yet "
                                      "(see ROADMAP.md, parallelism)")
        _check_model(cfg)
        # pack the decode weights once (fused projection, compressors, FF)
        self.params = params = fuse_decode_params(params, cfg)
        self.cfg = cfg
        self.device = params["token_emb"].device
        dtype = _compute_dtype(cfg) if dtype is None else dtype
        self.max_batch = max_batch
        self.max_len = max_len
        self.route = route
        self.temperature = float(temperature)
        self.filter_thres = float(filter_thres)
        self._host_gen = torch.Generator().manual_seed(seed)
        self._dev_gen = torch.Generator(device=self.device).manual_seed(seed)
        # tokens per host round trip; admission and retirement between syncs
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.buckets = tuple(sorted(prefill_buckets))
        self.paged = paged_pool_pages is not None
        nsa = cfg.nsa
        if self.paged:
            if not cfg.use_sparse_attn:
                raise NotImplementedError("the paged KV pool is sparse-attention only")
            if route == "split":
                raise NotImplementedError("the paged KV pool takes the fused route only")
            stride = nsa.compress_block_sliding_stride
            lcm = page_tokens * stride // math.gcd(page_tokens, stride)
            if page_tokens % nsa.selection_block_size or page_tokens % 8 or max_len % lcm:
                raise ValueError("page_tokens must be a multiple of selection_block_size and 8, "
                                 "and max_len a multiple of lcm(page, stride)")
            self.page_tokens = page_tokens
            self.max_pages = max_len // page_tokens
            self._page_lcm = lcm
            self._total_pages = paged_pool_pages
            self.trash_page = paged_pool_pages               # the last physical page
            d, kvh = cfg.dim_head, cfg.kv_heads
            wc = _ckv_width(max_len, stride, nsa.num_compress_per_fine)

            def zeros(*shape):
                return torch.zeros(shape, dtype=dtype, device=self.device)

            self.cache_layers = tuple(
                NSADecodeCache(kv=zeros(paged_pool_pages + 1, kvh, page_tokens, 2 * d),
                               ckv=zeros(max_batch, kvh, wc, 2 * d),
                               ring=zeros(max_batch, kvh, nsa.compress_block_size, 2 * d))
                for _ in range(cfg.depth))
            self.page_table = np.full((max_batch, self.max_pages), self.trash_page, np.int32)
            self._pt_dev = self._to_dev(self.page_table)
            self._free_pages: deque = deque(range(paged_pool_pages))
            self._slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        else:
            self.cache_layers = tuple(init_layer_cache(cfg, max_batch, max_len, dtype,
                                                       self.device)
                                      for _ in range(cfg.depth))
        self.seq_lens = np.zeros(max_batch, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.pending: deque = deque()
        self.finished: Dict[int, np.ndarray] = {}
        self._next_token = np.zeros(max_batch, np.int32)
        self._rid = 0

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- request API ------------------------------------------------------

    def add_request(self, prompt: np.ndarray, max_new_tokens: int,
                    stop_byte: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) + 1 > self.max_len:
            raise ValueError(f"prompt length {len(prompt)} + 1 exceeds engine max_len "
                             f"{self.max_len}; truncate the prompt or raise max_len")
        rid = self._rid
        self._rid += 1
        req = Request(rid, prompt, max_new_tokens, stop_byte)
        if self.paged and self._pages_needed(req) > self._total_pages:
            raise ValueError(f"request needs {self._pages_needed(req)} pages but the pool "
                             f"only has {self._total_pages}; raise paged_pool_pages")
        self.pending.append(req)
        return rid

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def _pages_needed(self, req: Request) -> int:
        """Pages covering the request's lifetime: prompt rows plus every
        decode write (the first token comes from the prefill), plus up to
        steps_per_sync - 1 rows a multi-step window may write past
        retirement."""
        rows = min(len(req.prompt) + req.max_new_tokens + self.steps_per_sync, self.max_len)
        return -(-rows // self.page_tokens)

    def _release_pages(self, slot: int):
        if not self.paged:
            return
        self._free_pages.extend(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.page_table[slot, :] = self.trash_page
        self._pt_dev = self._to_dev(self.page_table)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return round_up_mult(n, self.buckets[-1])

    # -- engine steps -----------------------------------------------------

    def _admit(self):
        """Prefill every pending request that fits into free slots, as one
        wave: the prompts right-padded to one bucket, one prefill call, one
        [n] readback of the first tokens."""
        if not self.pending:
            return
        wave = []                                    # (slot, request)
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None and self.pending:
                if self.paged:
                    # reserve the request's whole lifetime of pages now, in
                    # FIFO order: a head too big for the free pages blocks
                    # the queue rather than being starved by smaller ones
                    req = self.pending[0]
                    need = self._pages_needed(req)
                    if len(self._free_pages) < need:
                        break
                    self.pending.popleft()
                    pages = [self._free_pages.popleft() for _ in range(need)]
                    self._slot_pages[slot] = pages
                    self.page_table[slot, :] = self.trash_page
                    self.page_table[slot, :need] = pages
                    wave.append((slot, req))
                else:
                    wave.append((slot, self.pending.popleft()))
        if not wave:
            return
        bucket = min(max(self._bucket(max(len(r.prompt), 1)) for _, r in wave), self.max_len)
        ids = np.zeros((len(wave), bucket), np.int32)
        tls = np.ones(len(wave), np.int32)
        for i, (_, req) in enumerate(wave):
            ids[i, :len(req.prompt)] = req.prompt
            tls[i] = len(req.prompt)
        slots = [slot for slot, _ in wave]
        if self.paged:
            # prefill at the bucket (page-rounded), not max_len: decode goes
            # on past it through the reserved pages
            bucket_up = round_up_mult(bucket, self._page_lcm)
            first_toks, cache = wave_prefill(self.params, self.cfg, self._to_dev(ids).long(),
                                             bucket_up, self._to_dev(tls))
            n_pg = bucket_up // self.page_tokens
            # P + 1, past the pool: pages beyond a row's reservation are dropped
            phys = np.full((len(wave), n_pg), self._total_pages + 1, np.int64)
            for i, slot in enumerate(slots):
                k = min(n_pg, len(self._slot_pages[slot]))
                phys[i, :k] = self._slot_pages[slot][:k]
            _paged_merge_wave(self.cache_layers, cache.layers, phys, slots)
            self._pt_dev = self._to_dev(self.page_table)
        else:
            first_toks, cache = wave_prefill(self.params, self.cfg, self._to_dev(ids).long(),
                                             self.max_len, self._to_dev(tls))
            slot_idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
            for pool, new in zip(self.cache_layers, cache.layers):
                for leaf, new_leaf in zip(pool, new):
                    leaf.index_copy_(0, slot_idx, new_leaf.to(leaf.dtype))
        first_toks = first_toks.cpu().numpy()                   # one [n] readback
        for i, (slot, req) in enumerate(wave):
            req.slot = slot
            self.seq_lens[slot] = len(req.prompt)
            first = int(first_toks[i])
            self._next_token[slot] = first
            req.generated.append(first)
            self.slot_req[slot] = req
            self._maybe_retire(slot)

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        self.finished[req.rid] = np.asarray(req.generated, np.int32)
        self.slot_req[slot] = None
        self.seq_lens[slot] = 0
        self._release_pages(slot)

    def _maybe_retire(self, slot: int):
        req = self.slot_req[slot]
        if req is None:
            return
        if len(req.generated) >= req.max_new_tokens or (
                req.stop_byte is not None and req.generated
                and req.generated[-1] == req.stop_byte):
            self._finish(slot)

    def _decode_args(self):
        return (self.params, self.cfg, self._to_dev(self._next_token).long(),
                self.cache_layers, self._to_dev(self.seq_lens))

    def step(self):
        """One engine iteration: admit, ragged-decode, retire."""
        self._admit()
        if self.num_active == 0:
            return
        # a multi-step window only when it fits in every active slot's cache
        # room; the tail single-steps
        if self.steps_per_sync > 1 and self._room() >= self.steps_per_sync:
            self._multi_step()
            return
        if self.paged:
            logits, self.cache_layers = ragged_decode_step_paged(*self._decode_args(),
                                                                 self._pt_dev, route=self.route)
        else:
            logits, self.cache_layers = ragged_decode_step(*self._decode_args(), route=self.route)
        nxt_all = self._sample_host(logits.cpu().numpy())
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.seq_lens[slot] += 1
            nxt = int(nxt_all[slot])
            req.generated.append(nxt)
            self._next_token[slot] = nxt
            if self.seq_lens[slot] + 1 >= self.max_len:
                self._finish(slot)
                continue
            self._maybe_retire(slot)

    def _sample_host(self, logits: np.ndarray) -> np.ndarray:
        """Next tokens from [B, vocab] logits on the host (the single-step
        path reads the logits back anyway); the semantics of
        ``_sample_from_logits``."""
        if self.temperature <= 0:
            return np.argmax(logits, axis=-1)
        vocab = logits.shape[-1]
        k = max(1, -int(-((1.0 - self.filter_thres) * vocab) // 1))
        kth = np.sort(logits, axis=-1)[:, -k][:, None]
        filtered = np.where(logits >= kth, logits, -np.inf)
        u = np.maximum(torch.rand(logits.shape, generator=self._host_gen).numpy(), 1e-20)
        gumbel = -np.log(-np.log(u))
        return np.argmax(filtered / self.temperature + gumbel, axis=-1)

    def _room(self) -> int:
        """Smallest cache headroom over the active slots."""
        return min(self.max_len - 1 - int(self.seq_lens[s])
                   for s, r in enumerate(self.slot_req) if r is not None)

    def _multi_step(self):
        """``steps_per_sync`` tokens per active slot in one device loop; at
        temperature 0 token for token what single steps give."""
        k = self.steps_per_sync
        kw = dict(temperature=self.temperature, filter_thres=self.filter_thres,
                  generator=self._dev_gen, route=self.route)
        if self.paged:
            toks, self.cache_layers = ragged_decode_multi_paged(*self._decode_args(),
                                                                self._pt_dev, k, **kw)
        else:
            toks, self.cache_layers = ragged_decode_multi(*self._decode_args(), k, **kw)
        toks = toks.cpu().numpy()                               # one [B, k] readback
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            for j in range(k):
                self.seq_lens[slot] += 1
                nxt = int(toks[slot, j])
                req.generated.append(nxt)
                self._next_token[slot] = nxt
                done = len(req.generated) >= req.max_new_tokens or (
                    req.stop_byte is not None and nxt == req.stop_byte)
                if done or self.seq_lens[slot] + 1 >= self.max_len:
                    self._finish(slot)
                    break

    def run(self, max_steps: int = 10_000) -> Dict[int, np.ndarray]:
        steps = 0
        while (self.pending or self.num_active) and steps < max_steps:
            self.step()
            steps += 1
        return dict(self.finished)
