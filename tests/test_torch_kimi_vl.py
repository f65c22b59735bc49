"""The Kimi-VL labeler's model (models/kimi_vl.py) and labeler
(saliency/vlm_labeler.py) against the plain float32 reference
(reference/kimi_vl.py) on the CPU, at a tiny size with seeded weights:
hidden 64, 4 decoder layers (layer 0 dense), 8 routed experts top 2 with 1
shared, a 32-wide latent, rope 16, and a 2-layer tower of width 32. Every
weight is drawn at 0.02 times the square root of the published width over
the tiny one, so that activations, attention scores and router logits have
the published model's magnitudes and position and routing faults show as
they would there.

Tolerances (relative L2 over the compared tensor):
* FLOAT32_TOL 1e-5: the port in float32 differs from the reference only in
  the order of its sums (SDPA against explicit softmax, grouped against
  looped experts, the absorbed decode against decompressed keys); read
  1e-7 to 1e-6;
* BF16_TOL 0.1: bf16 weights and activations round at 2^-9 relative at
  each of some 20 stored results on the way through 4 layers (the tower's
  output and the logits read 0.006-0.015); beyond that a token whose k-th
  and next expert scores lie within rounding of each other takes another
  expert than in float32, and its later layers' entries differ by tens of
  percent, so the latent cache of the last layer reads near 0.05;
* each planted fault reads at least FAULT_FACTOR times the bf16 port's
  reading of the same number.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from gabril_carla_tpu_torch.models import kimi_vl as M
from gabril_carla_tpu_torch.reference import kimi_vl as R

FLOAT32_TOL = 1e-5
BF16_TOL = 0.1
FAULT_FACTOR = 4.0
TINY = M.KimiVLConfig(vocab_size=1280, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                      num_hidden_layers=4, num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
                      num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
                      v_head_dim=16, vit_hidden_size=32, vit_layers=2, vit_heads=2, vit_intermediate_size=64)
PUBLISHED = M.KimiVLConfig()
IMAGE_AT, STEPS = 24, 3


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def tiny_model(dtype):
    model = M.KimiVL.random(TINY, 7, "cpu", 0.05, torch.float32)
    scale = {"language_model": (PUBLISHED.hidden_size / TINY.hidden_size) ** 0.5,
             "vision_tower": (PUBLISHED.vit_hidden_size / TINY.vit_hidden_size) ** 0.5,
             "multi_modal_projector": (PUBLISHED.merged_width / TINY.merged_width) ** 0.5}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.mul_(scale[name.split(".")[0]])
    if dtype == torch.bfloat16:
        model = copy.deepcopy(model).to(dtype)
        for m in model.modules():
            if isinstance(m, M.Router):
                m.e_score_correction_bias.data = m.e_score_correction_bias.data.float()
    return model


@pytest.fixture(scope="module", params=[torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def model(request):
    torch.manual_seed(0)
    return tiny_model(request.param)


def tol(model):
    return FLOAT32_TOL if model.language_model.embed_tokens.weight.dtype == torch.float32 else BF16_TOL


def cfg_dict():
    return dataclasses.asdict(TINY)


def images(n=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (n, 180, 320), generator=g, dtype=torch.uint8)
    return frames, torch.stack([R.pixels(f, (196, 336)) for f in frames])


def prompts(lengths, seed=2):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 1000, (sum(lengths),), generator=g)
    image = torch.randn(len(lengths), 84, TINY.hidden_size, generator=g)
    return ids, image


def run_port(model, lengths, ids, image, steps=STEPS):
    """Prefill, then ``steps`` greedy decode steps: (logits [B, steps + 1,
    V], the ids fed [B, steps])."""
    with torch.inference_mode():
        logits, cache = model.prefill(ids, lengths, image.to(model.language_model.embed_tokens.weight.dtype),
                                      IMAGE_AT, steps)
        out, fed = [logits], []
        for _ in range(steps):
            fed.append(out[-1].argmax(-1))
            out.append(model.decode(fed[-1], cache))
    return torch.stack(out, 1).float(), torch.stack(fed, 1)


def reference_logits(model, lengths, ids, image, fed, fault=None, keep_cache=None):
    starts = np.cumsum([0] + lengths)
    seqs = [(torch.cat([ids[starts[b]:starts[b + 1]], fed[b]]), image[b].float(), IMAGE_AT,
             torch.arange(lengths[b] - 1, lengths[b] + fed.shape[1])) for b in range(len(lengths))]
    return torch.stack(R.logits(model.state_dict(), cfg_dict(), seqs, fault=fault, keep_cache=keep_cache))


def test_tower_and_projector_match_reference(model):
    _, px = images()
    with torch.inference_mode():
        got = model.encode_images(px)
    want = torch.stack(R.vision(model.state_dict(), cfg_dict(), list(px)))
    assert got.shape == (2, 84, TINY.hidden_size)
    assert rel(got, want) < tol(model)


def test_prefill_and_latent_cache_decode_match_full_forward(model):
    """The ragged prefill's last logits and each absorbed decode step's,
    against the reference's full causal forward over prompt and fed ids."""
    lengths = [140, 151, 133]
    ids, image = prompts(lengths)
    got, fed = run_port(model, lengths, ids, image)
    want = reference_logits(model, lengths, ids, image, fed)
    worst = max(rel(got[b, i], want[b, i]) for b in range(3) for i in range(STEPS + 1))
    assert worst < tol(model), worst


def test_ragged_batch_matches_each_world_alone(model):
    lengths = [140, 151, 133]
    ids, image = prompts(lengths)
    together, fed = run_port(model, lengths, ids, image)
    starts = np.cumsum([0] + lengths)
    for b, n in enumerate(lengths):
        alone, fed_b = run_port(model, [n], ids[starts[b]:starts[b + 1]], image[b:b + 1])
        assert rel(alone[0, 0], together[b, 0]) < tol(model)
        if model.language_model.embed_tokens.weight.dtype == torch.float32:
            assert torch.equal(fed_b[0], fed[b])
            assert rel(alone[0], together[b]) < FLOAT32_TOL


@pytest.mark.parametrize("bias_scale", [0.0, 1.0, 4.0])
def test_grouped_experts_match_looped(model, bias_scale):
    """One expert layer, grouped products over sorted pairs, against the
    reference's loop over experts, with the correction bias (scaled to move
    the choice more or less) and the routed scaling factor."""
    layer = model.language_model.layers[1].mlp
    g = torch.Generator().manual_seed(3)
    dtype = model.language_model.embed_tokens.weight.dtype
    x = torch.randn(300, TINY.hidden_size, generator=g).to(dtype)
    bias = layer.gate.e_score_correction_bias.data.clone()
    try:
        layer.gate.e_score_correction_bias.data.mul_(bias_scale)
        with torch.inference_mode():
            got = layer(x)
        mw = {k: v.float() for k, v in layer.state_dict().items()}
        want = R._moe(x.float(), mw, cfg_dict(), None)
    finally:
        layer.gate.e_score_correction_bias.data.copy_(bias)
    assert rel(got, want) < tol(model)


def test_router_load_follows_the_bias():
    """The correction bias picks the experts and not their weights: a large
    bias on one expert routes every token to it, at its own sigmoid score."""
    router = tiny_model(torch.float32).language_model.layers[1].mlp.gate
    x = torch.randn(64, TINY.hidden_size)
    router.e_score_correction_bias.data.zero_()
    router.e_score_correction_bias.data[5] = 10.0
    idx, w = router(x)
    assert (idx == 5).any(1).all()
    scores = torch.sigmoid(x @ router.weight.T)
    chosen = scores.gather(1, idx)
    torch.testing.assert_close(w, chosen / chosen.sum(1, keepdim=True) * TINY.routed_scaling_factor)


def test_balance_routers_brings_the_heaviest_expert_to_the_target():
    """The aux-free sign update moves only the correction biases, and stops
    once every expert layer's heaviest expert takes at most the target over
    the mean load of the batch it routes."""
    model = tiny_model(torch.float32)
    routers = [m for m in model.modules() if isinstance(m, M.Router)]
    with torch.no_grad():
        for r in routers:  # one expert favoured in every layer
            r.e_score_correction_bias.zero_()
            r.e_score_correction_bias[3] = 0.3
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(3)
    lengths = [140, 150, 160]
    ids = torch.randint(0, 1000, (sum(lengths),), generator=gen)
    image = torch.randn(3, 2, TINY.hidden_size, generator=gen)
    with torch.inference_mode():
        ratios = M.balance_routers(model, lambda: model.prefill(ids, lengths, image, IMAGE_AT, 0), 1.5, 0.02, 60)
    assert len(ratios) == TINY.num_hidden_layers - TINY.first_k_dense_replace
    assert max(ratios) <= 1.5
    for k, v in model.state_dict().items():
        if not k.endswith("e_score_correction_bias"):
            assert torch.equal(v, before[k]), k
    assert all(float(r.e_score_correction_bias[3]) < 0.3 for r in routers)


def test_planted_faults_fail():
    """Each fault of the reference, put in the port's place, reads at least
    FAULT_FACTOR times the bf16 port's reading of the number that catches
    it: the tower's output (2D RoPE off), the logits (routing, bias, shared
    experts) or the latent cache (RoPE off on the latent's key)."""
    m16 = tiny_model(torch.bfloat16)
    st, cfg = m16.state_dict(), cfg_dict()
    _, px = images(1)
    with torch.inference_mode():
        port_img = m16.encode_images(px)[0]
    ref_img = R.vision(st, cfg, list(px))[0]
    lengths = [150, 137]
    ids, image = prompts(lengths)
    got, fed = run_port(m16, lengths, ids, image)
    ref_cache = []
    want = reference_logits(m16, lengths, ids, image, fed, keep_cache=ref_cache)
    port = {"vision": rel(port_img, ref_img), "logits": rel(got, want)}
    with torch.inference_mode():
        _, cache = m16.prefill(ids, lengths, image.bfloat16(), IMAGE_AT, 0)
    port["cache"] = max(rel(kv[b, :n], r[b][:n]) for b, n in enumerate(lengths)
                        for kv, r in zip(cache.kv, zip(*ref_cache)))
    caught = {"no_vit_rope": "vision", "top5": "logits", "no_bias": "logits", "no_shared": "logits",
              "no_rope_k": "cache"}
    assert set(caught) == set(R.FAULTS)
    for fault, number in caught.items():
        if number == "vision":
            reading = rel(R.vision(st, cfg, list(px), fault=fault)[0], ref_img)
        else:
            fault_cache = []
            bad = reference_logits(m16, lengths, ids, image, fed, fault=fault, keep_cache=fault_cache)
            reading = rel(bad, want) if number == "logits" else max(
                rel(f[:n], r[:n]) for b, n in enumerate(lengths) for f, r in zip(fault_cache[b], ref_cache[b]))
        assert port[number] < BF16_TOL and reading > FAULT_FACTOR * port[number], (fault, reading, port)


def test_labeler_prompt_and_parse_match_reference():
    from gabril_carla_tpu_torch.saliency.vlm_labeler import CLASS_COLORS, LabelerConfig, VLMLabeler

    lab = VLMLabeler(tiny_model(torch.float32), LabelerConfig(seed=5))
    g = torch.Generator().manual_seed(4)
    b, a = 3, 30
    boxes = torch.zeros(b, a, 8)
    boxes[..., 0] = torch.rand(b, a, generator=g) * 400 - 40
    boxes[..., 1] = boxes[..., 0] + torch.rand(b, a, generator=g) * 60
    boxes[..., 2] = torch.rand(b, a, generator=g) * 220 - 20
    boxes[..., 3] = boxes[..., 2] + torch.rand(b, a, generator=g) * 40
    boxes[..., 4] = torch.rand(b, a, generator=g) * 120
    boxes[..., 5] = torch.tensor(CLASS_COLORS)[torch.randint(0, 4, (b, a), generator=g)]
    boxes[..., 6] = (torch.rand(b, a, generator=g) < 0.7).float()
    boxes[0, :, 6] = 0.0  # a world with no visible box
    p = lab.prompt(boxes)
    lay = dataclasses.asdict(lab.layout)
    starts = np.cumsum([0] + p.lengths)
    gen = torch.randint(lab.layout.box0 - 2, lab.layout.box0 + 18, (b, 9), generator=g)
    coords = lab.parse(gen, p)
    for w in range(b):
        ids, listed = R.prompt_ids(lab.template, 24, lab.n_image, boxes[w], lay, (180, 320), 16, 80.0, CLASS_COLORS)
        assert torch.equal(p.ids[starts[w]:starts[w + 1]], ids)
        assert p.lengths[w] == 132 + 7 * len(listed) and len(listed) <= 16
        want = R.parse_coords(gen[w].numpy(), listed.numpy(), lab.layout.box0, (180, 320), 5)
        np.testing.assert_array_equal(coords[w].numpy(), want)
    assert p.lengths[0] == 132 and (coords[0] == -1).all()


def test_collect_with_labeler_writes_the_parse_of_its_ids():
    """collect(labeler=) on three real routes for two ticks: each tick's
    coordinates are the reference's parse of the ids the labeler generated
    from that tick's frame and scene boxes, which the reference's own prompt
    assembly gives as well."""
    from gabril_carla_tpu_torch.cli import collect as C
    from gabril_carla_tpu_torch.env.world import load_benchmark_specs, to_torch
    from gabril_carla_tpu_torch.saliency.vlm_labeler import CLASS_COLORS, LabelerConfig, VLMLabeler

    lab = VLMLabeler(tiny_model(torch.float32), LabelerConfig(seed=6))
    seen = []
    real_generate, real_prompt = lab.generate, lab.prompt

    def prompt(boxes):
        p = real_prompt(boxes)
        seen.append({"boxes": boxes.clone(), "prompt": p})
        return p

    def generate(frames, p):
        out = real_generate(frames, p)
        seen[-1].update(frames=frames.clone(), generated=out)
        return out

    lab.prompt, lab.generate = prompt, generate
    spec = to_torch(load_benchmark_specs([3100, 2416, 24211]), "cpu")
    state, frames, actions, gazes, pseudo = C.collect(spec, 2, C.seed_draws([1, 2, 3], 2, "cpu"), labeler=lab)
    assert pseudo.shape == (2, 3, 10) and len(seen) == 2
    lay = dataclasses.asdict(lab.layout)
    for t, rec in enumerate(seen):
        assert torch.equal(rec["frames"], frames[t])
        starts = np.cumsum([0] + rec["prompt"].lengths)
        for w in range(3):
            ids, listed = R.prompt_ids(lab.template, 24, lab.n_image, rec["boxes"][w], lay, (180, 320), 16, 80.0,
                                       CLASS_COLORS)
            assert torch.equal(rec["prompt"].ids[starts[w]:starts[w + 1]], ids)
            want = R.parse_coords(rec["generated"][w].numpy(), listed.numpy(), lab.layout.box0, (180, 320), 5)
            np.testing.assert_array_equal(pseudo[t, w].numpy(), want)


def test_collect_cli_writes_vlm_gaze_after_fitting_the_routers(tmp_path, monkeypatch):
    """``collect --gaze vlm`` (here with the tiny model in place of the
    published one): the routers are fitted once on the worlds' reset
    frames, then gaze_pseudo.npz holds a label a tick beside gaze.npz."""
    from gabril_carla_tpu_torch.cli import collect as C

    real_labeler, real_balance = C.vlm_labeler, C.balance_labeler
    fits = []
    monkeypatch.setattr(C, "vlm_labeler", lambda seed, cfg, device: real_labeler(seed, cfg, device, TINY,
                                                                                 torch.float32))
    monkeypatch.setattr(C, "balance_labeler", lambda lab, spec: fits.append(real_balance(lab, spec)) or fits[-1])
    argv = ["--route", "3100", "--seeds", "1", "2", "--steps", "3", "--gaze", "vlm", "--vlm_seed", "4",
            "--out", str(tmp_path)]
    assert C.main(argv, device="cpu") == 0
    assert len(fits) == 1 and len(fits[0]) == TINY.num_hidden_layers - TINY.first_k_dense_replace
    for seed in (1, 2):
        ep = tmp_path / "route_3100" / f"seed_{seed}"
        pseudo, gaze = np.load(ep / "gaze_pseudo.npz")["gaze"], np.load(ep / "gaze.npz")["gaze"]
        assert pseudo.shape == gaze.shape == (3, 10)


def test_benchmark_labeler_settings_are_the_programs():
    """The benchmark's configuration states the labeler's settings as the
    program's defaults hold them (the router bias's draw and fit among
    them), so the CLI and the cell run one labeler."""
    import json
    from pathlib import Path

    from gabril_carla_tpu_torch.saliency.vlm_labeler import LabelerConfig

    root = Path(R.__file__).resolve().parents[2]
    stated = json.loads((root / "drivebench/configs/kimi_vl.json").read_text())["assumed"]["labeler"]
    defaults = dataclasses.asdict(LabelerConfig())
    shared = set(stated) & set(defaults)
    assert shared >= {"router_bias_std", "balance_target", "balance_step", "balance_passes", "decode_steps"}
    for k in shared:
        assert list(np.atleast_1d(stated[k])) == list(np.atleast_1d(defaults[k])), k


def test_published_sizes_and_reference_copy():
    """The published configuration's parameter count, and the benchmark's
    copy of the reference is this one."""
    from pathlib import Path

    n = M.parameter_count(PUBLISHED)
    assert n["decoder"] == 15_960_110_208 and n["vision"] == 447_545_840
    root = Path(R.__file__).resolve().parents[2]
    assert (root / "drivebench/reference/kimi_vl.py").read_bytes() == Path(R.__file__).read_bytes()
