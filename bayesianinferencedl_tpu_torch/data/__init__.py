"""Dataset generation (parameter -> ROM-error pairs)."""
