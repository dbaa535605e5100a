"""BER-vs-SNR sweep protocols and the result CSV schema (`sweep`), the
MATLAB `.mat` waveform interop (`mat_export`, `mat_eval`) and BER plots
(`plots`)."""
