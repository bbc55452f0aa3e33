"""Analytic byte models (counterpart of ``repro.roofline.analysis``, the
serve-wire, speculative serve-wire and paged-residency models). Pure arithmetic on the policy
formulas and the config, so their outputs must equal the reference's
exactly."""
from __future__ import annotations


def serve_host_device_bytes(
    plan_or_policy,
    vocab_size: int,
    *,
    n_slots: int,
    prompt_lens,
    decode_steps: int,
    page_table_entries: int = 0,
) -> dict:
    """Host<->device staging bytes of one continuous-batching engine run;
    ``ServeEngine.wire_summary()["host_device"]`` must equal ``total``
    for the run's observed geometry:

      * ``prompt_h2d``      — each admitted prompt staged once, h2d;
      * ``first_token_d2h`` — one sampled id per admission, d2h;
      * ``decode_token_io`` — per decode step the full slot batch both
        ways (feed h2d + sampled ids d2h), retired-slot ballast included;
      * ``page_table_h2d``  — paged engines' page table (raw int32) per
        decode step; 0 entries for the contiguous layout.
    """
    pol = plan_or_policy
    if hasattr(pol, "host_device_policies"):  # a PrecisionPlan
        pol = pol.host_device_policies()[0]
    prompt_lens = list(prompt_lens)
    tok = pol.token_host_bytes
    table = {
        "prompt_h2d": tok(sum(prompt_lens), vocab_size),
        "first_token_d2h": tok(len(prompt_lens), vocab_size),
        "decode_token_io": 2 * tok(n_slots, vocab_size) * int(decode_steps),
        "page_table_h2d": 4 * int(page_table_entries) * int(decode_steps),
        "token_width": pol.token_wire_width(vocab_size),
    }
    table["total"] = (
        table["prompt_h2d"] + table["first_token_d2h"]
        + table["decode_token_io"] + table["page_table_h2d"]
    )
    return table


def serve_spec_decode_bytes(
    plan_or_policy,
    vocab_size: int,
    *,
    n_slots: int,
    prompt_lens,
    spec_rounds: int,
    spec_k: int,
    page_table_entries: int = 0,
) -> dict:
    """Host<->device staging bytes of one speculative engine run;
    ``ServeEngine.wire_summary()["host_device"]`` must equal ``total``.
    The arithmetic of :func:`serve_host_device_bytes`, reshaped by the
    draft/verify protocol (``T = spec_k + 1``):

      * ``prompt_h2d``      — each admitted prompt staged once, h2d (the
        draft prefills from the same staged device tokens);
      * ``first_token_d2h`` — one sampled id per admission, d2h;
      * ``draft_h2d``       — per round ``T`` draft micro steps, each
        feeding the full slot batch one token h2d;
      * ``draft_d2h``       — per round ``k`` proposal batches d2h (the
        last micro step only absorbs);
      * ``verify_token_io`` — per round the ``(B, T)`` verify block h2d and
        the ``T`` verified ids a slot d2h;
      * ``page_table_h2d``  — paged engines' (spec-widened) table per
        verify step, raw int32.
    """
    pol = plan_or_policy
    if hasattr(pol, "host_device_policies"):  # a PrecisionPlan
        pol = pol.host_device_policies()[0]
    prompt_lens = list(prompt_lens)
    tok = pol.token_host_bytes
    rounds, k = int(spec_rounds), int(spec_k)
    T = k + 1
    table = {
        "prompt_h2d": tok(sum(prompt_lens), vocab_size),
        "first_token_d2h": tok(len(prompt_lens), vocab_size),
        "draft_h2d": rounds * tok(n_slots * T, vocab_size),
        "draft_d2h": rounds * tok(n_slots * k, vocab_size),
        "verify_token_io": 2 * rounds * tok(n_slots * T, vocab_size),
        "page_table_h2d": 4 * int(page_table_entries) * rounds,
        "token_width": pol.token_wire_width(vocab_size),
    }
    table["total"] = (
        table["prompt_h2d"] + table["first_token_d2h"]
        + table["draft_h2d"] + table["draft_d2h"]
        + table["verify_token_io"] + table["page_table_h2d"]
    )
    return table


def serve_paged_kv_bytes(
    cfg,
    *,
    page_size: int,
    requests,
    shared_prefix_len: int = 0,
    int8_kv: bool = False,
    dtype_bytes: int = 4,
) -> dict:
    """Page-granular KV residency of the paged serve engine when every
    request is resident at once: ``ServeEngine.kv_residency()["pages_peak"]``
    must equal ``pages`` then.

    ``requests`` is an iterable of ``(prompt_len, max_new_tokens)``;
    ``shared_prefix_len`` tokens are common to ALL requests, so their whole
    pages (``shared_prefix_len // page_size``) are stored once instead of
    per request. Per page, every attention layer holds K + V: ``2 *
    page_size * num_kv_heads * head_dim`` elements of ``dtype_bytes`` (1
    for int8 KV, which then adds two fp32 scale planes of ``page_size *
    num_kv_heads`` each).
    """
    reqs = list(requests)
    layers = cfg.num_groups * cfg.layers_per_group
    attn_frac = sum(1 for k in cfg.pattern if k == "attn") / len(cfg.pattern)
    attn_layers = int(layers * attn_frac)
    kv_elems = page_size * cfg.num_kv_heads * cfg.head_dim
    per_layer = 2 * kv_elems * (1 if int8_kv else dtype_bytes)
    if int8_kv:
        per_layer += 2 * page_size * cfg.num_kv_heads * 4  # fp32 scales
    bytes_per_page = per_layer * attn_layers
    shared_pages = shared_prefix_len // page_size
    private_pages = sum(-(-(s + g) // page_size) - shared_pages for s, g in reqs)
    pages = shared_pages + private_pages
    return {
        "bytes_per_page": bytes_per_page,
        "shared_pages": shared_pages,
        "private_pages": private_pages,
        "pages": pages,
        "kv_bytes_resident": pages * bytes_per_page,
    }
