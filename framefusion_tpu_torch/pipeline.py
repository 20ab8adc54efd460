"""Text-level pipeline: checkpoint + tokenizer + frames -> answer text
(port of ``framefusion_tpu.pipeline``, the LLaVA-Video / Qwen2 families).

Given a tokenizer (HF AutoTokenizer or anything with encode/decode), LLM
params, a vision tower and frames, it builds the LLaVA-style chat prompt,
encodes the frames (preprocess -> SigLIP -> LLaVA frontend), splices the
video features at the media placeholder, runs the (compressed) prefill and
greedy decode, and decodes text. Embeddings stay on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .interface import FrameFusionModel
from .models import qwen2
from .models.adapters import llava_video

DEFAULT_TEMPLATE = (
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    "<|im_start|>user\n<image>\n{question}<|im_end|>\n<|im_start|>assistant\n"
)

# Families whose prompt building the JAX pipeline has and this one does not yet.
_NOT_PORTED = {
    "qwen2_vl": "ROADMAP Queue 1 item 11 (qwen2_vl: mRoPE and its towers)",
    "internvl": "ROADMAP Queue 1 item 11 (internvl: InternViT and the InternLM2 import)",
    "minicpmv": "ROADMAP Queue 1 item 11 (minicpmv and its frontend)",
    "nvila": "ROADMAP Queue 1 item 11 (nvila and its frontend)",
}


@dataclasses.dataclass
class TextPipeline:
    """End-to-end video QA for the LLaVA-Video / Qwen2-stack families: chat
    template with one ``<image>`` placeholder, frame-major feature block."""

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
        quantizes the decoder weights on the host during import."""
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
        return self.chat_template if self.chat_template is not None else DEFAULT_TEMPLATE

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

    def build_inputs(self, question: str, frames=None, video_features=None):
        """Tokenize the chat prompt and splice the video features.

        Also records ``last_prompt_ids``, the prompt's text token ids
        (placeholder rows dropped). ``frames`` may be raw uint8 (T, H, W, C)
        video frames: they are resized and normalized to the tower's
        geometry in-repo (preprocess.py); float frames are taken as already
        preprocessed."""
        if self.model.family in _NOT_PORTED:
            raise NotImplementedError(f"{self.model.family}: prompt building is not ported to PyTorch yet "
                                      f"({_NOT_PORTED[self.model.family]})")
        self._prompt_ids_acc = []
        try:
            inputs = self._build_llava_inputs(question, self._prepare_frames(frames), video_features)
        finally:
            self.last_prompt_ids = list(self._prompt_ids_acc)
            self._prompt_ids_acc = None
        return inputs

    def _prepare_frames(self, frames):
        """Raw uint8 frames -> the family's normalized model pixels at the
        tower's ``image_size``. Float inputs pass through untouched."""
        if frames is None:
            return None
        frames = np.asarray(frames)
        if frames.dtype != np.uint8:
            return frames
        from . import preprocess as pp

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
                                          attn_impl=self.model.attn_impl)

        ids = ids_before + [self.PLACEHOLDER_ID] + ids_after
        text_embeds = self._embed_ids(ids)
        feats = torch.as_tensor(video_features).to(device=self.device, dtype=torch.float32)
        pps = self.vit_cfg.patches_per_side if self.vit_cfg is not None else 27
        return llava_video.build_prefill_inputs(text_embeds, feats, image_token_pos=len(ids_before),
                                                num_patches_per_side=pps)

    def ask(self, question: str, frames=None, video_features=None, max_new_tokens: int = 64,
            eos_token_id: Optional[int] = None, speculative: bool = False) -> str:
        """Answer ``question`` about the video (frames or precomputed
        features) with greedy decoding; the prefill result is kept in
        ``last_result``."""
        if speculative:
            raise NotImplementedError("speculative decoding is not ported to PyTorch yet "
                                      "(ROADMAP Queue 1 item 13: runtime/spec_decode.py)")
        inputs = self.build_inputs(question, frames=frames, video_features=video_features)
        eos = eos_token_id if eos_token_id is not None else getattr(self.tokenizer, "eos_token_id", None)
        tokens, result = self.model.generate(inputs, max_new_tokens, eos_token_id=eos)
        self.last_result = result
        return self.tokenizer.decode(tokens)
