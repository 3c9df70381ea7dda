"""The modes a traffic mix names: each runs one part of the pipeline in the
window (set-up, window, answers)."""
