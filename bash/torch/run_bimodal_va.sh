#!/bin/sh
# VA (vision-audio) pre-training on one NVIDIA GPU with the PyTorch/CUDA
# package: bash/run_bimodal_va.sh pointed at `python -m vipant_tpu_torch`.
#
#   bash bash/torch/run_bimodal_va.sh bimodal [override ...]
#
# Left out of the JAX script: `mesh.data=-1`. The port runs one process on
# one card (multi-device training is ROADMAP.md queue A, A15), so the
# contrastive loss sees the batch of that card. Other backbones: BACKBONE
# picks both towers' config, `vit_val` (the default, with the reference's
# 3-channel 16 x 24 audio patching), `rn50_val` (with CLIP_MODEL_NAME=RN50)
# or `deit` (with `model.audio.meme_path=<timm .pth>` after the run type).
# A second `+model/audio=...` after the run type would merge into vit_val's
# groups, not replace them. `model.audio.patchout=0.25` drops a quarter of
# the audio patches in training; `async_ckpt=True` writes the checkpoints in
# the background; `platform=cpu` runs on the CPU.

run_type=${1:-bimodal}
[ $# -ge 1 ] && shift  # remaining args pass through as config overrides

# data/model roots: override from the environment for real runs
data_root=${DATA_ROOT:-/data/audioset}
data_name=${DATA_NAME:-src_unbalanced_train_segments}
eval_name=${EVAL_NAME:-src_balanced_train_segments}
clip_root=${CLIP_MODEL_ROOT:-/models/clip}
clip_name=${CLIP_MODEL_NAME:-ViT-B32}
model_name=${MODEL_NAME:-test}
batch_size=${BATCH_SIZE:-432}   # the reference's released B
num_proc=${NUM_PROC:-2}
backbone=${BACKBONE:-vit_val}

towers="+model/image=$backbone +model/audio=$backbone"
if [ "$backbone" = vit_val ]; then
  towers="$towers model.audio.pre_encoder.in_channels=3 model.audio.pre_encoder.stride=[16,24]"
fi

mtask="
model_name=$model_name worker=CVAP monitor=VAMonitor num_proc=$num_proc eval=False verbose=True
$towers +model/text=dummy +model/loss=ce
+optimizer=standard +running/audio=default
optimizer.warmup=False running.audio.norms=[-4.93839311,5.75751113]
running.epochs=1 running.batch_size=$batch_size running.peep_rate=50
running.save_rate=100 running.eval_samples=100
running.data_root=$data_root running.data_name=$data_name
running.eval_name=$eval_name
running.clip_model_root=$clip_root running.clip_model_name=$clip_name
"

python -m vipant_tpu_torch +running=$run_type $mtask "$@"
