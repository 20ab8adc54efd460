"""Text-level pipeline: checkpoint + tokenizer + frames -> answer text
(port of ``framefusion_tpu.pipeline``, every family of ``FAMILIES``).

Given a tokenizer (HF AutoTokenizer or anything with encode/decode), LLM
params, a vision tower and frames, it builds the family's chat prompt,
encodes the frames (preprocess -> SigLIP -> the LLaVA frontend, NVILA's
``mlp_downsample`` connector or MiniCPM-V's resampler; preprocess at
``smart_resize``'s geometry -> the Qwen2-VL or Qwen2.5-VL tower; or
preprocess to 448x448 -> InternViT -> pixel shuffle -> ``mlp1``), splices
the video features at the media placeholders, runs the (compressed) prefill
and greedy decode, and decodes text. Embeddings stay on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .interface import FrameFusionModel
from .models import qwen2
from .models.adapters import internvl, llava_video, minicpmv, nvila, qwen2_vl
from .runtime.profiling import span

DEFAULT_TEMPLATE = (
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    "<|im_start|>user\n<image>\n{question}<|im_end|>\n<|im_start|>assistant\n"
)

# Qwen2-VL's processor expands the video into
# <|vision_start|><|video_pad|>...<|vision_end|>; here the single
# <|video_pad|> marks where the visual embeddings splice in.
QWEN2_VL_TEMPLATE = (
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    "<|im_start|>user\n<|vision_start|><|video_pad|><|vision_end|>"
    "{question}<|im_end|>\n<|im_start|>assistant\n"
)
# InternVL chat builds an interleaved 'FrameN: <image>\n' prefix, one line a
# frame (reference example_internvl.py:139-141); each frame's features
# splice in at its <image>.
INTERNVL_TEMPLATE = "<|im_start|>user\n{video_prefix}{question}<|im_end|>\n<|im_start|>assistant\n"

FAMILY_TEMPLATES = {"qwen2_vl": QWEN2_VL_TEMPLATE, "internvl": INTERNVL_TEMPLATE}


@dataclasses.dataclass
class TextPipeline:
    """End-to-end video QA. Prompt building dispatches on ``model.family``:

      * LLaVA-Video / LLaVA-NeXT-Video: chat template with one ``<image>``
        placeholder, frame-major feature block;
      * ``nvila``: the same one block (SigLIP + the ``mlp_downsample``
        connector's tokens, or precomputed features with the
        ``nvila_num_frames`` attribute set);
      * ``minicpmv``: each frame's resampled block followed by two separator
        rows, the frames' bounds giving the adapter its geometry;
      * ``qwen2_vl``: the vision span at ``<|video_pad|>`` with 3D mRoPE
        position ids from the video grid (the tower's, or ``video_grid_thw``
        beside precomputed features); with a Qwen2.5-VL tower the temporal
        stream advances by ``second_per_grid_ts`` x its
        ``tokens_per_second``;
      * ``internvl``: an interleaved ``FrameN: <image>`` line a frame, each
        frame's features at its ``<image>`` (InternViT's, or precomputed
        (n_frames, tokens_per_frame, D) features).
    """

    model: FrameFusionModel
    tokenizer: object  # .encode(str) -> list[int], .decode(list[int]) -> str
    vit_params: Optional[dict] = None
    vit_cfg: Optional[object] = None
    projector: Optional[dict] = None
    image_token: str = "<image>"
    chat_template: Optional[str] = None

    # Sentinel for media-placeholder rows in id lists handed to _embed_ids:
    # embeds as row 0 (the spliced feature replaces it) but never enters the
    # prompt's id history; a real tokenizer may use id 0 for a real token.
    PLACEHOLDER_ID = -1

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, cost: float = 0.3,
                        similarity_lower_bound: Optional[float] = None, ratio_lower_bound: float = 0.1,
                        quantize: Optional[str] = None, dtype=torch.bfloat16, tokenizer=None,
                        device=None) -> "TextPipeline":
        """Hub-layout checkpoint dir -> an ``ask()``-able pipeline in one call.
        The tokenizer loads from the same directory through
        transformers.AutoTokenizer (local files) unless one is passed; S_th
        defaults to the family's value (interface.FAMILIES). ``quantize="int8"``
        quantizes the decoder weights on the device during import, a layer
        at a time.
        ``device=None`` puts the model on the card and raises without one;
        ``device="cpu"`` asks for the CPU."""
        from .interface import FAMILIES, apply_framefusion
        from .weights import load_checkpoint

        model = load_checkpoint(checkpoint_dir, dtype=dtype, quantize=quantize, device=device)
        if similarity_lower_bound is None:
            similarity_lower_bound = FAMILIES[model.family].default_similarity_lower_bound
        model = apply_framefusion(model, cost, similarity_lower_bound, ratio_lower_bound)
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(checkpoint_dir)
        vision = model.vision or {}
        return cls(model=model, tokenizer=tokenizer, vit_params=vision.get("params"), vit_cfg=vision.get("cfg"),
                   projector=vision.get("projector"))

    def _template(self) -> str:
        if self.chat_template is not None:
            return self.chat_template
        return FAMILY_TEMPLATES.get(self.model.family, DEFAULT_TEMPLATE)

    def _render_prompt(self, media: str, question: str, fallback: str) -> str:
        """The chat prompt: through the tokenizer's ``chat_template`` when it
        carries one (and no template was set here), else the static
        template. The media placeholder stays in the user turn either way."""
        if self.chat_template is None and getattr(self.tokenizer, "chat_template", None):
            return self.tokenizer.apply_chat_template(
                [{"role": "user", "content": f"{media}{question}"}], tokenize=False, add_generation_prompt=True)
        return fallback

    @property
    def device(self) -> torch.device:
        return self.model.params["embed"].device

    def _embed_ids(self, ids) -> torch.Tensor:
        """Token ids -> (T, D) fp32 embeddings on the model's device (the JAX
        pipeline's fp32 host rows; the engine casts to the model dtype)."""
        ids = np.asarray(ids, np.int64)
        if getattr(self, "_prompt_ids_acc", None) is not None:
            self._prompt_ids_acc.extend(int(i) for i in ids if i >= 0)
        rows = torch.as_tensor(np.where(ids < 0, 0, ids), device=self.device)
        return qwen2.embed(self.model.params, rows).to(torch.float32)

    def build_inputs(self, question: str, frames=None, video_features=None, video_grid_thw=None,
                     second_per_grid_ts=None):
        """Tokenize the family's chat prompt and splice the video features.

        Also records ``last_prompt_ids``, the prompt's text token ids
        (placeholder rows dropped). ``frames`` may be raw uint8 (T, H, W, C)
        video frames: they are resized and normalized to the tower's
        geometry in-repo (preprocess.py); float frames are taken as already
        preprocessed. ``video_grid_thw`` goes with precomputed Qwen2-VL
        ``video_features``; ``second_per_grid_ts`` is Qwen2.5-VL's seconds a
        temporal grid step (1.0 when None)."""
        self._prompt_ids_acc = []
        try:
            with span("pipeline.build_inputs"):
                frames = self._prepare_frames(frames)
                if self.model.family == "qwen2_vl":
                    inputs = self._build_qwen2_vl_inputs(question, frames, video_features, video_grid_thw,
                                                         second_per_grid_ts)
                elif self.model.family == "internvl":
                    inputs = self._build_internvl_inputs(question, frames, video_features)
                elif self.model.family == "minicpmv":
                    inputs = self._build_minicpmv_inputs(question, frames, video_features)
                elif self.model.family == "nvila":
                    inputs = self._build_nvila_inputs(question, frames, video_features)
                else:
                    inputs = self._build_llava_inputs(question, frames, video_features)
        finally:
            self.last_prompt_ids = list(self._prompt_ids_acc)
            self._prompt_ids_acc = None
        return inputs

    def _prepare_frames(self, frames):
        """Raw uint8 frames -> the family's normalized model pixels: for
        Qwen2-VL at ``smart_resize``'s geometry with factor = patch_size *
        spatial_merge_size (the HF processor's rule), else at the tower's
        ``image_size`` (SigLIP, InternViT). Float inputs pass through
        untouched."""
        if frames is None:
            return None
        frames = np.asarray(frames)
        if frames.dtype != np.uint8:
            return frames
        from . import preprocess as pp

        if self.model.family == "qwen2_vl":
            if self.vit_cfg is None:
                raise ValueError("uint8 frames need a vision tower")
            factor = self.vit_cfg.patch_size * self.vit_cfg.spatial_merge_size
            return pp.preprocess_frames(frames, self.model.family, factor=factor)
        if self.vit_cfg is None or not hasattr(self.vit_cfg, "image_size"):
            raise ValueError("uint8 frames need a fixed-size vision tower (image_size)")
        size = self.vit_cfg.image_size
        return pp.preprocess_frames(frames, self.model.family, target=(size, size))

    def _build_llava_inputs(self, question: str, frames, video_features):
        prompt = self._render_prompt(f"{self.image_token}\n", question, self._template().format(question=question))
        before, _, after = prompt.partition(self.image_token)
        ids_before = list(self.tokenizer.encode(before))
        ids_after = list(self.tokenizer.encode(after))

        if video_features is None:
            from .models.vision.llava_frontend import encode_video

            if frames is None or self.vit_params is None:
                raise ValueError("pass frames with a vision tower (vit_params/vit_cfg/projector), or video_features")
            video_features = encode_video(self.vit_params, self.vit_cfg, self.projector, frames,
                                          attn_impl=self.model.resolved_attn_impl())

        with span("pipeline.prompt"):
            ids = ids_before + [self.PLACEHOLDER_ID] + ids_after
            text_embeds = self._embed_ids(ids)
            feats = torch.as_tensor(video_features).to(device=self.device, dtype=torch.float32)
            pps = self.vit_cfg.patches_per_side if self.vit_cfg is not None else 27
            return llava_video.build_prefill_inputs(text_embeds, feats, image_token_pos=len(ids_before),
                                                    num_patches_per_side=pps)

    def _build_qwen2_vl_inputs(self, question: str, frames, video_features, video_grid_thw,
                               second_per_grid_ts=None):
        """Qwen2-VL and Qwen2.5-VL: one vision span at ``<|video_pad|>``, 3D
        mRoPE ids from the video grid. Frames run through the tower that
        ``vit_cfg`` names (``pixels_to_patches``, one patch layout for both,
        -> that tower's ``encode_video``, kernel E under
        ``attn_impl="flash"``); precomputed ``video_features`` need
        ``video_grid_thw``. With a Qwen2.5-VL tower the temporal stream
        advances by absolute time: ``second_per_grid_ts`` (1.0 when None:
        temporal patch 2 at 2 fps, the HF processor's default) times the
        tower's ``tokens_per_second``; the Qwen2-VL rule steps by one (the
        adapter's ``tokens_per_second`` 2 is then unused)."""
        from .models.vision import qwen2_vl_vit, qwen25_vl_vit

        is_qwen25 = isinstance(self.vit_cfg, qwen25_vl_vit.Qwen25VLViTConfig)
        if video_features is None:
            if frames is None or self.vit_params is None:
                raise ValueError("qwen2_vl needs frames with a Qwen2-VL or Qwen2.5-VL tower (vit_params/vit_cfg), "
                                 "or video_features with video_grid_thw")
            patches, video_grid_thw = qwen2_vl_vit.pixels_to_patches(np.asarray(frames, np.float32), self.vit_cfg)
            tower = qwen25_vl_vit if is_qwen25 else qwen2_vl_vit
            with span("vision.tower"):  # its patch merger included
                video_features = tower.encode_video(self.vit_params, patches, *video_grid_thw, self.vit_cfg,
                                                    attn_impl=self.model.resolved_attn_impl())
        if video_grid_thw is None:
            raise ValueError("qwen2_vl video_features need video_grid_thw")
        grid_t, grid_h, grid_w = (int(x) for x in video_grid_thw)
        with span("pipeline.prompt"):
            prompt = self._render_prompt("<|vision_start|><|video_pad|><|vision_end|>", question,
                                         self._template().format(question=question))
            before, _, after = prompt.partition("<|video_pad|>")
            ids_before = list(self.tokenizer.encode(before))
            ids_after = list(self.tokenizer.encode(after))
            text_embeds = self._embed_ids(ids_before + [self.PLACEHOLDER_ID] + ids_after)
            feats = torch.as_tensor(video_features).to(device=self.device, dtype=torch.float32)
            merge = getattr(self.vit_cfg, "spatial_merge_size", 2)
            if is_qwen25 and second_per_grid_ts is None:
                second_per_grid_ts = 1.0
            return qwen2_vl.build_prefill_inputs(text_embeds, feats, video_token_pos=len(ids_before), grid_t=grid_t,
                                                 grid_h=grid_h, grid_w=grid_w, spatial_merge_size=merge,
                                                 second_per_grid_ts=second_per_grid_ts,
                                                 tokens_per_second=self.vit_cfg.tokens_per_second if is_qwen25
                                                 else 2)

    def _build_internvl_inputs(self, question: str, frames, video_features):
        """InternVL: a ``FrameN: <image>`` line a frame, each frame's features
        at its ``<image>`` (reference example_internvl.py:139-141 and
        modeling_internvl_chat.py:19-71). Frames run through InternViT, the
        pixel shuffle and the ``mlp1`` projector (``extract_features``,
        kernel E under ``attn_impl="flash"``); precomputed ``video_features``
        are (n_frames, tokens_per_frame, D)."""
        if video_features is None:
            from .models.vision.internvl_vit import extract_features

            if frames is None or self.vit_params is None or self.projector is None:
                raise ValueError("internvl needs frames with an InternViT tower (vit_params/vit_cfg/projector), "
                                 "or per-frame video_features")
            video_features = extract_features(self.vit_params, self.projector, np.asarray(frames, np.float32),
                                              self.vit_cfg, attn_impl=self.model.resolved_attn_impl())
        with span("pipeline.prompt"):
            feats = torch.as_tensor(video_features).to(device=self.device, dtype=torch.float32)
            if feats.ndim != 3:
                raise ValueError(f"internvl video_features must be (n_frames, tokens_per_frame, D), got "
                                 f"{tuple(feats.shape)}")
            n_frames, tpf, _ = feats.shape
            video_prefix = "".join(f"Frame{i + 1}: {self.image_token}\n" for i in range(n_frames))
            prompt = self._render_prompt(video_prefix, question,
                                         self._template().format(video_prefix=video_prefix, question=question))
            segments = prompt.split(self.image_token)
            if len(segments) != n_frames + 1:
                raise ValueError(f"the prompt holds {len(segments) - 1} {self.image_token} placeholders for "
                                 f"{n_frames} frames")
            embeds, mask = [], []
            for i, seg in enumerate(segments):
                ids = list(self.tokenizer.encode(seg))
                if ids:
                    embeds.append(self._embed_ids(ids))
                    mask.append(np.zeros(len(ids), bool))
                if i < n_frames:
                    embeds.append(feats[i])
                    mask.append(np.ones(tpf, bool))
            return internvl.build_prefill_inputs(torch.cat(embeds), np.concatenate(mask), tokens_per_frame=tpf)

    def _build_minicpmv_inputs(self, question: str, frames, video_features):
        """MiniCPM-V: each frame's resampled block at the ``<image>`` line,
        followed by two separator rows (the first two ids of ``")\\n"``, the
        ``(<image>./</image>)\\n`` suffix, padded with placeholders), one
        bound a frame (reference modeling_minicpmv.py:80-107). Frames run
        through SigLIP and the resampler (``projector={"params", "cfg"}``;
        kernel E under ``attn_impl="flash"``); precomputed
        ``video_features`` are (n_frames, tokens_per_frame, D)."""
        if video_features is None:
            from .models.vision.minicpmv_frontend import encode_video

            if frames is None or self.vit_params is None or not self.projector:
                raise ValueError("minicpmv needs frames with SigLIP (vit_params/vit_cfg) and a resampler "
                                 "(projector={'params', 'cfg'}), or (n_frames, tokens_per_frame, D) video_features")
            video_features = encode_video(self.vit_params, self.vit_cfg, self.projector["params"],
                                          self.projector["cfg"], np.asarray(frames, np.float32),
                                          attn_impl=self.model.resolved_attn_impl())
        with span("pipeline.prompt"):
            feats = torch.as_tensor(video_features).to(device=self.device, dtype=torch.float32)
            if feats.ndim != 3:
                raise ValueError(f"minicpmv video_features must be (n_frames, tokens_per_frame, D), got "
                                 f"{tuple(feats.shape)}")
            n_frames, tpf, _ = feats.shape
            prompt = self._render_prompt(f"{self.image_token}\n", question, self._template().format(question=question))
            before, _, after = prompt.partition(self.image_token)
            emb_before = self._embed_ids(list(self.tokenizer.encode(before)))
            emb_after = self._embed_ids(list(self.tokenizer.encode(after)))
            sep = self._embed_ids((list(self.tokenizer.encode(")\n")) + [self.PLACEHOLDER_ID] * 2)[:2])
            chunks, bounds, cursor = [emb_before], [], emb_before.shape[0]
            for f in range(n_frames):
                chunks += [feats[f], sep]
                bounds.append([cursor, cursor + tpf])
                cursor += tpf + 2
            chunks.append(emb_after)
            return minicpmv.build_prefill_inputs(torch.cat(chunks), np.asarray(bounds), num_frames=n_frames)

    def _build_nvila_inputs(self, question: str, frames, video_features):
        """NVILA: one contiguous media block at the ``<image>`` placeholder
        (reference llava_arch.py:85-104). Frames run through SigLIP to its
        penultimate layer and the ``mlp_downsample`` connector
        (``projector={"params", "cfg"}``; kernel E under
        ``attn_impl="flash"``); precomputed (n_frames * patch_num, D)
        ``video_features`` need the ``nvila_num_frames`` attribute."""
        if video_features is None:
            from .models.vision.nvila_frontend import encode_video

            if frames is None or self.vit_params is None or not self.projector:
                raise ValueError("nvila needs frames with SigLIP (vit_params/vit_cfg) and a connector "
                                 "(projector={'params', 'cfg'}), or video_features with nvila_num_frames set")
            frames = np.asarray(frames, np.float32)
            video_features = encode_video(self.vit_params, self.vit_cfg, self.projector["params"],
                                          self.projector["cfg"], frames, attn_impl=self.model.resolved_attn_impl())
            n_frames = frames.shape[0]
        else:
            n_frames = getattr(self, "nvila_num_frames", None)
            if not n_frames:
                raise ValueError("set pipeline.nvila_num_frames with precomputed nvila video_features")
        with span("pipeline.prompt"):
            prompt = self._render_prompt(f"{self.image_token}\n", question, self._template().format(question=question))
            before, _, after = prompt.partition(self.image_token)
            ids_before = list(self.tokenizer.encode(before))
            ids_after = list(self.tokenizer.encode(after))
            text_embeds = self._embed_ids(ids_before + [self.PLACEHOLDER_ID] + ids_after)
            feats = torch.as_tensor(video_features).to(device=self.device, dtype=torch.float32)
            return nvila.build_prefill_inputs_video(text_embeds, feats, media_token_pos=len(ids_before),
                                                    num_frames=n_frames)

    def ask(self, question: str, frames=None, video_features=None, max_new_tokens: int = 64,
            eos_token_id: Optional[int] = None, video_grid_thw=None, second_per_grid_ts=None,
            speculative: bool = False, draft_len: int = 4) -> str:
        """Answer ``question`` about the video (frames, or precomputed
        features with ``video_grid_thw`` for Qwen2-VL; ``second_per_grid_ts``
        for a Qwen2.5-VL tower, as in ``build_inputs``) with greedy decoding;
        the prefill result is kept in ``last_result``. ``speculative=True``
        decodes by draft-and-verify with the prompt's text ids
        (``last_prompt_ids``) seeding the drafts: the same answer."""
        inputs = self.build_inputs(question, frames=frames, video_features=video_features,
                                   video_grid_thw=video_grid_thw, second_per_grid_ts=second_per_grid_ts)
        eos = eos_token_id if eos_token_id is not None else getattr(self.tokenizer, "eos_token_id", None)
        tokens, result = self.model.generate(inputs, max_new_tokens, eos_token_id=eos, speculative=speculative,
                                             draft_len=draft_len,
                                             prompt_ids=self.last_prompt_ids if speculative else None)
        self.last_result = result
        return self.tokenizer.decode(tokens)
