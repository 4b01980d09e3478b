"""The plain reference of the dense GQA decoders (Qwen2.5, Yi): plain PyTorch
in float32 with TF32 off, a layer at a time so that it fits beside the
weights.  It imports nothing of the program and takes nothing the program
made: the weights it reads are the benchmark's (``weights.py``), and it
works out again every cache, state and logit.

The decoder, as published: token embedding; per layer h += Attn(RMSNorm(h)),
h += MLP(RMSNorm(h)), RMSNorm(x) = x / sqrt(mean(x^2) + eps) * w; attention
with q/k/v projections (a bias each where ``qkv_bias``), rotary embedding of
the two halves of each head (theta ``rope_theta``), grouped-query causal
softmax attention at 1/sqrt(Dh), output projection; a SwiGLU MLP,
down(silu(gate x) * up x); a final RMSNorm and the head.

``precision="fp8"`` is the control: every operand of every projection
rounded to float8 e4m3 with one scale a tensor (its largest magnitude at
448), the step below the configuration's bfloat16.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0
ADAMW_CHUNK = 1 << 26     # elements of a leaf updated at a time
HEAD_SLICE = 16384        # vocabulary columns of the serving reference's head at a time


def precise() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_scale(x: torch.Tensor) -> torch.Tensor:
    return x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX


def quant(x: torch.Tensor, precision: str, scale: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` as the precision holds it (float8: one scale for the tensor,
    or ``scale``); under autograd the backward passes straight through."""
    if precision == "fp32":
        return x
    if precision != "fp8":
        raise ValueError(precision)
    scale = fp8_scale(x) if scale is None else scale
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach()) if x.requires_grad else q


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    return quant(x, precision) @ quant(w, precision)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(S: int, Dh: int, theta: float, device, offset: int = 0):
    """cos, sin (S, Dh/2), the angles in float64."""
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float64, device=device) / Dh)
    ang = torch.arange(offset, offset + S, dtype=torch.float64, device=device)[:, None] * inv
    return ang.cos().float(), ang.sin().float()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (S, heads, Dh): the halves (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class DenseDecoder:
    """The reference for one configuration file (a dict)."""

    def __init__(self, cfg: dict, precision: str = "fp32"):
        self.cfg = cfg
        self.D = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.Hkv = cfg["num_key_value_heads"]
        self.Dh = cfg.get("head_dim", self.D // self.H)
        self.L = cfg["num_hidden_layers"]
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.precision = precision

    # ---- weights ----
    def layer_weights(self, params: dict, i: int, requires_grad: bool = False) -> dict:
        """Layer i's weights in float32 (fresh tensors), flat names."""
        p = params["blocks"][i]
        D, H, Hkv, Dh = self.D, self.H, self.Hkv, self.Dh
        w = {"ln1": p["ln1"]["w"], "ln2": p["ln2"]["w"],
             "q": p["attn"]["q"]["w"].reshape(D, H * Dh),
             "k": p["attn"]["k"]["w"].reshape(D, Hkv * Dh),
             "v": p["attn"]["v"]["w"].reshape(D, Hkv * Dh),
             "o": p["attn"]["o"]["w"].reshape(H * Dh, D),
             "gate": p["mlp"]["gate"]["w"], "up": p["mlp"]["up"]["w"],
             "down": p["mlp"]["down"]["w"]}
        for name in ("q", "k", "v"):
            if "b" in p["attn"][name]:
                w[name + "_b"] = p["attn"][name]["b"].reshape(-1)
        return {k: v.float().requires_grad_(requires_grad) for k, v in w.items()}

    # ---- one layer over one sequence ----
    def layer(self, h: torch.Tensor, w: dict, cos, sin) -> torch.Tensor:
        """h (S, D) float32 -> the layer's output (S, D)."""
        S = h.shape[0]
        H, Hkv, Dh, G = self.H, self.Hkv, self.Dh, self.H // self.Hkv
        pr = self.precision
        x = rmsnorm(h, w["ln1"], self.eps)
        q, k, v = (mm(x, w[n], pr) + w[n + "_b"] if n + "_b" in w else mm(x, w[n], pr)
                   for n in ("q", "k", "v"))
        q = rotate(q.view(S, H, Dh), cos, sin)
        k = rotate(k.view(S, Hkv, Dh), cos, sin)
        v = v.view(S, Hkv, Dh)
        # q head j attends with kv head j // G; one kv head at a time
        qpos = torch.arange(S, device=h.device).repeat(G)
        mask = torch.arange(S, device=h.device)[None, :] > qpos[:, None]
        outs = []
        for j in range(Hkv):
            qg = q[:, j * G:(j + 1) * G].permute(1, 0, 2).reshape(G * S, Dh)
            s = (qg @ k[:, j].t()) / math.sqrt(Dh)                          # (G*S, S)
            s = s.masked_fill(mask, float("-inf"))
            outs.append((torch.softmax(s, dim=-1) @ v[:, j]).view(G, S, Dh))
        o = torch.cat(outs, dim=0).permute(1, 0, 2).reshape(S, H * Dh)
        h = h + mm(o, w["o"], pr)
        x = rmsnorm(h, w["ln2"], self.eps)
        f = torch.nn.functional.silu(mm(x, w["gate"], pr)) * mm(x, w["up"], pr)
        return h + mm(f, w["down"], pr)

    def head(self, params: dict, h: torch.Tensor, requires_grad: bool = False):
        """(logits, (final norm's w, head's w)) for rows h (n, D)."""
        wf = params["final_norm"]["w"].float().requires_grad_(requires_grad)
        wh = (params["embed"]["w"].t() if self.cfg["tie_word_embeddings"]
              else params["lm_head"]["w"]).float().requires_grad_(requires_grad)
        return mm(rmsnorm(h, wf, self.eps), wh, self.precision), (wf, wh)

    # ---- serving: logits at chosen positions of whole sequences ----
    @torch.no_grad()
    def logits_at(self, params: dict, seqs: list[list[int]], positions: list[list[int]]):
        """For each sequence (token ids) the float32 logits (len(pos), V) at
        its positions ``pos``: row j predicts the token after position
        pos[j].  Layer by layer over all the sequences."""
        dev = params["embed"]["w"].device
        E = params["embed"]["w"]
        hs = [E[torch.tensor(s, device=dev)].float() for s in seqs]
        tables = {}
        for i in range(self.L):
            w = self.layer_weights(params, i)
            for j, h in enumerate(hs):
                S = h.shape[0]
                if S not in tables:
                    tables[S] = rope_tables(S, self.Dh, self.theta, dev)
                hs[j] = self.layer(h, w, *tables[S])
            del w
        wf = params["final_norm"]["w"].float()
        wh = params["embed"]["w"].t() if self.cfg["tie_word_embeddings"] \
            else params["lm_head"]["w"]
        w_scale = fp8_scale(wh)
        out = []
        for h, pos in zip(hs, positions):
            x = quant(rmsnorm(h[torch.tensor(pos, device=dev)], wf, self.eps), self.precision)
            # the head a slice of the vocabulary at a time, one scale for all of it
            out.append(torch.cat([x @ quant(wh[:, a:a + HEAD_SLICE].float(), self.precision,
                                            w_scale)
                                  for a in range(0, wh.shape[1], HEAD_SLICE)], dim=1))
        return out

    # ---- training: steps of AdamW from the benchmark's weights ----
    def train_steps(self, params: dict, batches: list[dict], hyper: dict, *,
                    half_batch: bool = False) -> dict:
        """AdamW steps over ``batches`` from ``params`` (the benchmark's
        first weights, in their served type: updated in place, each update
        computed in float32 and rounded back to that type, as the
        configuration keeps them).  Returns each step's loss, and each
        leaf's gradient norm at the first step (by path name).
        ``half_batch``: the fault that leaves out half of the tokens and
        takes the mean over the rest."""
        from chipbench.weights import leaf_specs, path_name, get_leaf
        state: dict = {}
        losses, grad_norms = [], {}
        self._leaves = {path_name(p): p for p, *_ in leaf_specs(self.cfg)}
        for step, batch in enumerate(batches, start=1):
            grads_seen = {}

            def apply(path, g, step=step, grads_seen=grads_seen):
                name = path_name(path)
                if step == 1:
                    grads_seen[name] = float(torch.linalg.vector_norm(g))
                self._adamw(get_leaf(params, path), g, state, name, step, hyper)

            losses.append(self._one_step(params, batch, apply, half_batch))
            if step == 1:
                grad_norms = grads_seen
        return {"losses": losses, "grad_norms": grad_norms}

    def _one_step(self, params: dict, batch: dict, apply, half_batch: bool) -> float:
        dev = params["embed"]["w"].device
        tokens = torch.as_tensor(batch["tokens"]).to(dev).long()
        labels = torch.as_tensor(batch["labels"]).to(dev).long()
        if tokens.shape[0] != 1:
            raise ValueError("the reference trains one sequence a step (B1)")
        tokens, labels = tokens[0], labels[0]
        S = tokens.shape[0]
        cos, sin = rope_tables(S, self.Dh, self.theta, dev)
        E = params["embed"]["w"]
        saved = []
        with torch.no_grad():
            h = E[tokens].float()
            for i in range(self.L):
                saved.append(h)
                h = self.layer(h, self.layer_weights(params, i), cos, sin)
        hL = h.requires_grad_(True)
        logits, (wf, wh) = self.head(params, hL, requires_grad=True)
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(1, labels[:, None])[:, 0]
        loss = nll[: S // 2].mean() if half_batch else nll.mean()
        loss.backward()
        value = float(loss.detach())
        del logits, nll, loss
        apply(("final_norm", "w"), wf.grad)
        head_path = ("embed", "w") if self.cfg["tie_word_embeddings"] else ("lm_head", "w")
        if not self.cfg["tie_word_embeddings"]:
            apply(head_path, wh.grad)
        dh = hL.grad
        del wf, wh, hL
        for i in reversed(range(self.L)):
            if dev.type == "cuda":
                torch.cuda.empty_cache()      # the layer's temporaries differ in size
            hi = saved[i].requires_grad_(True)
            w = self.layer_weights(params, i, requires_grad=True)
            out = self.layer(hi, w, cos, sin)
            out.backward(dh)
            dh = hi.grad
            saved[i] = None
            for name, t in w.items():
                apply(self._layer_path(i, name), t.grad.view(self._layer_shape(params, i, name)))
            del w, out, hi
        gE = torch.zeros(E.shape, dtype=torch.float32, device=dev)
        gE.index_add_(0, tokens, dh)
        apply(("embed", "w"), gE)
        return value

    _NAMES = {"ln1": ("ln1", "w"), "ln2": ("ln2", "w"), "q": ("attn", "q", "w"),
              "k": ("attn", "k", "w"), "v": ("attn", "v", "w"), "o": ("attn", "o", "w"),
              "q_b": ("attn", "q", "b"), "k_b": ("attn", "k", "b"), "v_b": ("attn", "v", "b"),
              "gate": ("mlp", "gate", "w"), "up": ("mlp", "up", "w"),
              "down": ("mlp", "down", "w")}

    def _layer_path(self, i: int, name: str) -> tuple:
        return ("blocks", i) + self._NAMES[name]

    def _layer_shape(self, params: dict, i: int, name: str):
        node = params["blocks"][i]
        for key in self._NAMES[name]:
            node = node[key]
        return node.shape

    @staticmethod
    @torch.no_grad()
    def _adamw(p: torch.Tensor, g: torch.Tensor, state: dict, name: str, step: int,
               hyper: dict) -> None:
        """m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
        p -= lr ((m / c1) / (sqrt(v / c2) + eps) + wd p), lr warmed up
        linearly over ``warmup`` steps to ``peak_lr``."""
        b1, b2, eps, wd = hyper["b1"], hyper["b2"], hyper["eps"], hyper["weight_decay"]
        lr = hyper["peak_lr"] * min(step / hyper["warmup"], 1.0)
        if step > hyper["warmup"]:
            raise ValueError("the reference follows the warm-up steps only")
        if name not in state:
            state[name] = (torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                           torch.zeros(p.shape, dtype=torch.float32, device=p.device))
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        flat = [t.reshape(-1) for t in (p, g, *state[name])]
        for a in range(0, flat[0].numel(), ADAMW_CHUNK):     # bounded temporaries
            pc, gc, mc, vc = (t[a:a + ADAMW_CHUNK] for t in flat)
            gc = gc.float()
            mc.mul_(b1).add_(gc, alpha=1 - b1)
            vc.mul_(b2).addcmul_(gc, gc, value=1 - b2)
            pf = pc.float()
            u = (mc / c1) / ((vc / c2).sqrt() + eps) + wd * pf
            pc.copy_(pf - lr * u)


Reference = DenseDecoder
