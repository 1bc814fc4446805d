#!/bin/bash
# The MFA alignment stage with the port's command lines (counterpart of
# data_prep/runall_mfa.sh): restructure LibriTTS-R per speaker, run the
# Montreal Forced Aligner (an external program; the whole corpus takes
# days), then merge the wav24k and TextGrid trees. Run from any working
# directory; the relative defaults below resolve against it:
#   LIBRITTS_R_DIR (./LibriTTS_R), OUTPUT_DIR (./out),
#   SPEAKERS_TSV (external/speakers.tsv), N_JOBS (64), DEBUG (false: true
#   keeps a small speaker subset), PYTHON (python3).
set -e

repo=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="${repo}${PYTHONPATH:+:${PYTHONPATH}}"
python=${PYTHON:-python3}

debug=${DEBUG:-false}
libritts_r_dir=${LIBRITTS_R_DIR:-./LibriTTS_R}
output_dir=${OUTPUT_DIR:-./out}
speakers_tsv=${SPEAKERS_TSV:-external/speakers.tsv}
n_jobs=${N_JOBS:-64}
mkdir -p "${output_dir}"

if [ "${debug}" == "true" ]; then
    extra_arg="--debug"
    prefix=debug_
else
    extra_arg=""
    prefix=""
fi
out_wav_dir=${output_dir}/${prefix}libritts_r_per_spk
out_textgrid_dir=${output_dir}/${prefix}libritts_r_per_spk_mfa
out_merged_dir=${output_dir}/${prefix}libritts_r_per_spk_cleaned

${python} -m promptttspp_tpu_torch.data_prep.prepare_mfa \
    "${libritts_r_dir}" "${out_wav_dir}" --n_jobs "${n_jobs}" \
    --speakers_tsv "${speakers_tsv}" ${extra_arg}

if [ ! -d "${out_textgrid_dir}" ]; then
    ${python} -m promptttspp_tpu_torch.data_prep.run_mfa \
        "${out_wav_dir}" "${out_textgrid_dir}" \
        --speakers_tsv "${speakers_tsv}" ${extra_arg}
fi

${python} -m promptttspp_tpu_torch.data_prep.finalize_mfa \
    "${out_wav_dir}" "${out_textgrid_dir}" "${out_merged_dir}" \
    --speakers_tsv "${speakers_tsv}"
