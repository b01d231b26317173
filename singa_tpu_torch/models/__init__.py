"""Model zoo: GPT-2, BERT, the char-RNN, the ResNet family, and the CNN
zoo (MLP, CNN, AlexNet, VGG, MobileNetV2, Xception, U-Net)."""
