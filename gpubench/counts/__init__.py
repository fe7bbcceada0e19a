"""The yardstick's arithmetic: peak rates of the card, each model's
operations a sample, and the bytes each sparse kernel has to move."""
