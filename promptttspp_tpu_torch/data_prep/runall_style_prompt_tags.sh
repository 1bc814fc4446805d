#!/bin/bash
# The style-prompt tagging stage with the port's command lines
# (counterpart of data_prep/runall_style_prompt_tags.sh): per-utterance
# statistics (LUFS, F0 by YIN on DEVICE, syllable rate), then the
# gender-normalized 5-level labels and the metadata CSV with the style
# keys and content prompts. Run after runall_mfa.sh, from the same
# working directory; the relative defaults below resolve against it:
#   LIBRITTS_R_DIR (./LibriTTS_R), METADATA_DIR (../metadata),
#   OUTPUT_DIR (./out), SPEAKERS_TSV (external/speakers.tsv),
#   N_JOBS (64), DEVICE (cuda), PYTHON (python3).
set -e

repo=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="${repo}${PYTHONPATH:+:${PYTHONPATH}}"
python=${PYTHON:-python3}

libritts_r_dir=${LIBRITTS_R_DIR:-./LibriTTS_R}
metadata_dir=${METADATA_DIR:-../metadata}
output_dir=${OUTPUT_DIR:-./out}
speakers_tsv=${SPEAKERS_TSV:-external/speakers.tsv}
n_jobs=${N_JOBS:-64}
device=${DEVICE:-cuda}

merged_dir=${output_dir}/libritts_r_per_spk_cleaned
f0_stats=${metadata_dir}/libritts_r_f0_stats.yaml
style_prompt_candidates=${metadata_dir}/style_prompt_candidates.csv

if [ ! -d "${merged_dir}" ]; then
    echo "You must first create the dataset with MFA alignments (runall_mfa.sh)"
    exit 1
fi

utt_metadata=${output_dir}/libritts_r_per_utt_metadata.yaml
out_csv_file=${output_dir}/metadata_w_style_prompt_key.csv

if [ ! -e "${utt_metadata}" ]; then
    ${python} -m promptttspp_tpu_torch.data_prep.compute_utt_stats \
        "${merged_dir}" "${f0_stats}" --out_filename "${utt_metadata}" \
        --num_jobs "${n_jobs}" --speakers_tsv "${speakers_tsv}" \
        --device "${device}"
fi

${python} -m promptttspp_tpu_torch.data_prep.add_style_prompt_tags \
    "${libritts_r_dir}" "${utt_metadata}" "${style_prompt_candidates}" \
    --out_filename "${out_csv_file}" --speakers_tsv "${speakers_tsv}"
